"""The port's rank meshes, Megatron specs and rank slices, and its
tensor-parallel forward, held against the JAX package's parallel/ and
engine/sharded/ on the CPU (tests/test_parallel.py and test_sharded.py
are the JAX package's own).

The JAX side runs on the 8 virtual CPU devices (tests/conftest.py); the
port's tp=2 side is two processes over gloo, the driver in this process
and one follower spawned by build_local_backend. MICRO is the JAX
package's tp test model (f32, 2 layers, 4 heads over 2 kv heads).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from k8s_llm_scheduler_tpu.engine.sharded import serving_param_specs as jserving_specs
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import forward_prefill as jforward_prefill
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.parallel import mesh as jmesh
from k8s_llm_scheduler_tpu.parallel import sharding as jsharding
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.sharded import (
    RankConfig,
    ServingPlane,
    build_plane,
    serving_param_specs,
)
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import init_params
from k8s_llm_scheduler_tpu_torch.models.loader import _expected_shapes, save_checkpoint
from k8s_llm_scheduler_tpu_torch.parallel import launch, mesh, sharding

ttesting.cap_torch_threads()

_MICRO = dict(name="sharded-micro", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=4096, rope_theta=10000.0,
              tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
TOL = 1e-4  # the JAX package's tp forward bound (tests/test_parallel.py)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}.{key}" if path else key)
    else:
        yield path, tree


def _global_shapes(cfg, quantized: bool) -> dict:
    shapes = dict(_expected_shapes(cfg))
    if quantized:
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            L, n_in, out = shapes.pop(f"layers.{key}")
            shapes[f"layers.{key}.q"] = (L, n_in, out)
            shapes[f"layers.{key}.scale"] = (L, 1, out)
    return shapes


@pytest.fixture(scope="module")
def micro_params():
    jp = jinit_params(jax.random.PRNGKey(0), JMICRO)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tp2(micro_params, tmp_path_factory):
    """A tp=2 backend serving MICRO's JAX weights: the config under its
    name in this process's registry (the driver resolves the model and
    hands its config to the follower), the weights a native checkpoint."""
    ckpt = tmp_path_factory.mktemp("micro") / "ckpt"
    save_checkpoint(ckpt, micro_params[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfigs._REGISTRY, TMICRO.name, TMICRO)
        backend = build_local_backend(
            TMICRO.name, device="cpu", checkpoint_path=str(ckpt), mesh_axes={"tp": 2},
            temperature=0.0, num_pages=64, page_size=16, max_slots=4, max_pages_per_seq=16,
            prefill_buckets=(32, 64, 128), chunk_steps=4, prefix_chunk=32,
            prewarm_idle_delay_s=600.0)
    yield backend
    backend.close()


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("axes", [None, {"tp": 2}, {"dp": 2, "tp": 4}, {"tp": 2, "sp": 2},
                                  {"dp": 1, "tp": 8}, {"fsdp": 2, "dp": 2, "tp": 2}])
def test_make_mesh_lays_out_axes_as_the_jax_mesh(axes):
    got = mesh.mesh_from_config(axes)
    want = jmesh.mesh_from_config(axes)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.devices.size
    assert mesh.axis_size(got, "tp") == jmesh.axis_size(want, "tp")
    # the grid of ranks follows the device grid's order
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(got.grid, ids - ids.min())


@pytest.mark.parametrize("axes,match", [({"bogus": 2}, "unknown mesh axis"),
                                        ({"dp": 4, "tp": 4}, "needs 16")])
def test_mesh_errors_match_the_jax_ones(axes, match):
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(axes)
    with pytest.raises(ValueError, match=match):
        mesh.make_mesh(axes, ranks=range(8))


def test_axis_groups_of_a_bound_mesh():
    m = mesh.make_mesh({"dp": 2, "tp": 4}).bind(None, 6, timeout_s=1.0, device_count=2)
    assert m.coords() == (1, 2)
    assert m.axis_ranks("tp") == [4, 5, 6, 7] and m.axis_ranks("dp") == [2, 6]
    assert m.axis_index("tp") == 2 and m.axis_index("sp") == 0
    assert m.local_device_index() == 0 and m.local_device_index(5) == 1
    with pytest.raises(ValueError, match="not in the mesh"):
        m.bind(None, 8, timeout_s=1.0)


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_70b_shard_shapes_equal_jax(tp, quantized):
    """Every leaf's spec and per-rank shape at Llama-3.3-70B equals the JAX
    package's NamedSharding shard shape on a tp mesh (shapes only)."""
    tcfg = tconfigs.get_config("llama-3.3-70b-instruct")
    jcfg = jconfigs.get_config("llama-3.3-70b-instruct")
    jm = jmesh.make_mesh({"tp": tp})
    tm = mesh.make_mesh({"tp": tp})
    tspecs = dict(_leaves(serving_param_specs(tcfg, quantized=quantized)))
    jspecs = dict(_leaves(jserving_specs(jcfg, quantized=quantized)))
    assert sorted(tspecs) == sorted(jspecs)
    shapes = _global_shapes(tcfg, quantized)
    assert sorted(shapes) == sorted(tspecs)
    for name, spec in tspecs.items():
        assert tuple(jspecs[name]) == spec, name
        want = NamedSharding(jm, P(*spec)).shard_shape(shapes[name])
        assert sharding.shard_shape(shapes[name], spec, tm) == tuple(want), name
    kv = (80, 512, 64, 8, 128)
    assert sharding.kv_cache_spec() == tuple(jsharding.kv_cache_spec())
    assert sharding.shard_shape(kv, sharding.kv_cache_spec(), tm) == tuple(
        NamedSharding(jm, jsharding.kv_cache_spec()).shard_shape(kv))


def test_rank_slices_equal_the_jax_addressable_shards(micro_params):
    """Each rank's slice of params_from_jax(...) is exactly the JAX
    package's addressable shard of that rank's device."""
    jp, tp_params = micro_params
    jm = jmesh.make_mesh({"tp": 2})
    placed = jsharding.shard_params(jp, jm, jserving_specs(JMICRO))
    specs = serving_param_specs(TMICRO)
    for rank in range(2):
        got = dict(_leaves(sharding.shard_params(tp_params, mesh.make_mesh({"tp": 2}),
                                                 rank, specs)))
        for name, leaf in _leaves(placed):
            shard = next(s for s in leaf.addressable_shards if s.device == jm.devices[rank])
            assert torch.equal(got[name], torch.from_numpy(np.array(shard.data))), name


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_sharded_init_equals_the_slices_of_the_full_init(tie):
    cfg = dataclasses.replace(tconfigs.TINY, tie_embeddings=tie)
    full = init_params(cfg, seed=5, device="cpu")
    for rank in range(2):
        m = mesh.make_mesh({"tp": 2}).bind(None, rank, timeout_s=1.0)
        shard = init_params(cfg, seed=5, device="cpu", shard=sharding.rank_ranges(cfg, m))
        want = dict(_leaves(ServingPlane(m).place_params(full, cfg)))
        for name, leaf in _leaves(shard):
            assert torch.equal(leaf, want[name]), name


def test_divisibility_errors_match_the_jax_ones():
    cfg8 = tconfigs.get_config("llama-3.1-8b-instruct")
    bad = dataclasses.replace(cfg8, n_kv_heads=4, n_heads=12, d_model=3072)
    jbad = dataclasses.replace(jconfigs.get_config("llama-3.1-8b-instruct"), n_kv_heads=4,
                               n_heads=12, d_model=3072)
    with pytest.raises(ValueError) as jerr:
        jsharding.validate_specs_divisibility(jbad, jmesh.make_mesh({"tp": 8}))
    with pytest.raises(ValueError) as terr:
        sharding.validate_specs_divisibility(bad, mesh.make_mesh({"tp": 8}))
    assert str(terr.value) == str(jerr.value)
    sharding.validate_specs_divisibility(cfg8, mesh.make_mesh({"tp": 8}))


def test_rank_config_keeps_head_dim_and_the_plane_is_none_at_tp1():
    m = mesh.make_mesh({"tp": 8}).bind(None, 3, timeout_s=1.0)
    plane = build_plane(m)
    local = plane.local_config(tconfigs.get_config("llama-3.3-70b-instruct"))
    assert isinstance(local, RankConfig) and local.plane is plane
    assert (local.n_heads, local.n_kv_heads, local.head_dim, local.q_per_kv, local.d_ff,
            local.vocab_size) == (8, 1, 128, 8, 3584, 128256)
    assert plane.vocab_range(128256) == (3 * 16032, 4 * 16032)
    assert build_plane(mesh.make_mesh({"tp": 1})) is None and build_plane(None) is None


# ----------------------------------------------------------- tp=2 forward
def test_tp2_forward_logits_match_the_jax_tp2_forward(micro_params, tp2):
    jp, _ = micro_params
    ids = [int(t) for t in np.random.default_rng(1).integers(0, 512, size=24)]
    tokens = jnp.asarray([ids], dtype=jnp.int32)
    lens = jnp.asarray([len(ids)], dtype=jnp.int32)
    jm = jmesh.make_mesh({"tp": 2})
    placed = jsharding.shard_params(jp, jm, jserving_specs(JMICRO))
    want, _, _ = jax.jit(jforward_prefill, static_argnums=(1,))(placed, JMICRO, tokens, lens)
    got = tp2.engine.rank_group.on_ranks(launch.prefill_logits, ids)
    assert torch.equal(got[0], got[1])  # the gather is exact: every rank reads the same
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], rtol=TOL, atol=TOL)


def test_tp2_rank_kv_is_the_jax_head_slice(micro_params, tp2):
    jp, _ = micro_params
    ids = list(b"CLUSTER STATE: node-0 cpu=10 node-1 cpu=11")
    tp2.engine.set_prefix(ids)
    tokens = jnp.asarray([ids], dtype=jnp.int32)
    _, jk, jv = jforward_prefill(jp, JMICRO, tokens, jnp.asarray([len(ids)], jnp.int32))
    per_rank = tp2.engine.rank_group.on_ranks(launch.prefix_kv)
    kv_local = TMICRO.n_kv_heads // 2
    for rank, (k, v) in enumerate(per_rank):
        heads = slice(rank * kv_local, (rank + 1) * kv_local)
        assert k.shape == (2, len(ids), kv_local, 16)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk)[:, 0, :, heads], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv)[:, 0, :, heads], atol=1e-5,
                                   rtol=1e-5)


def test_follower_ranks_import_no_jax(tp2):
    """The driver is this test process (which holds both packages); the
    spawned rank imports torch and the port only."""
    per_rank = tp2.engine.rank_group.on_ranks(launch.loaded_packages)
    follower = per_rank[1]
    assert "k8s_llm_scheduler_tpu_torch" in follower and "torch" in follower
    assert "jax" not in follower and "k8s_llm_scheduler_tpu" not in follower
    assert tp2.engine.plane.backend == "gloo"
    assert tp2.engine.rank_group.procs[0].exitcode is None


@pytest.mark.parametrize("devices,want", [([0, 1], "nccl"), ([0, 0], "gloo"),
                                          ([None, None], "gloo"), ([0, 1, 0, 1], "gloo"),
                                          ([0, 1, 2, 3, 4, 5, 6, 7], "nccl")])
def test_collective_backend_rule(devices, want):
    assert launch.choose_backend(devices) == want


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_sharded_checkpoint_load_equals_the_slices_of_the_full_load(tmp_path, quantize, tie):
    """load_hf_checkpoint(shard=) reads a rank's blocks: each equals the
    rank's slice of the whole checkpoint's load, int8 scales included (a
    row-parallel weight's scales span its whole input dim)."""
    from safetensors.torch import save_file

    from k8s_llm_scheduler_tpu_torch.models.loader import load_hf_checkpoint

    cfg = dataclasses.replace(TMICRO, tie_embeddings=tie, name=f"ckpt-{tie}")
    full = init_params(cfg, seed=3, device="cpu")
    hf = {"model.embed_tokens.weight": full["embed"], "model.norm.weight": full["final_norm"]}
    if not tie:
        hf["lm_head.weight"] = full["lm_head"].t().contiguous()
    names = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm", "w_gate": "mlp.gate_proj",
             "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    for key, hf_name in names.items():
        for i in range(cfg.n_layers):
            w = full["layers"][key][i]
            hf[f"model.layers.{i}.{hf_name}.weight"] = (w if w.dim() == 1 else w.t()).contiguous()
    save_file(hf, str(tmp_path / "model.safetensors"))
    whole = load_hf_checkpoint(tmp_path, cfg, device="cpu", quantize=quantize)
    specs = serving_param_specs(cfg, quantized=quantize is not None)
    for rank in range(2):
        m = mesh.make_mesh({"tp": 2}).bind(None, rank, timeout_s=1.0)
        got = load_hf_checkpoint(tmp_path, cfg, device="cpu", quantize=quantize,
                                 shard=sharding.rank_ranges(cfg, m))
        want = dict(_leaves(sharding.shard_params(whole, m, specs=specs)))
        assert sorted(dict(_leaves(got))) == sorted(want)
        for name, leaf in _leaves(got):
            assert torch.equal(leaf, want[name]), name
