"""The port's train step on a rank mesh (train/train_step.py with mesh=)
against the JAX package's make_train_step on the same mesh, on the CPU in
f32, and the two-host dry run (parallel/dryrun.py, the counterpart of
tools/dryrun_multihost.py).

Layouts: {dp2}, {fsdp2}, {tp2}, {sp2} (ring attention), and
tests/test_train.py's {dp2,sp2,tp2} and {dp2,fsdp2,tp2}. The same weights
(models/convert.params_from_jax) and the same batch: uneven seq_lens with
loss_start and loss_weights, so the whole batch's mean (not a mean of the
ranks' means) is what is checked. The JAX side runs on the 8 virtual CPU
devices (tests/conftest.py), one compile a layout: its gradients come from
one optax.sgd(1.0) step (old - new params), its AdamW params from
optax.adamw(LR) applied to them. The port's ranks are processes over gloo
(parallel/launch.run_spmd); one AdamW step gives the loss, the
gradients (gathered from the ranks) and the params after.

Tolerances (f32): the loss within 1e-5; every gradient leaf within rtol
1e-4 / atol 1e-6 of JAX's; the params after the step within 1e-3 * LR
except where |JAX grad| < 1e-6 (Adam's first step is +-LR there and may
flip: fewer than 0.1% of the elements). Leaves the ranks replicate are
bit-equal on every rank after the step, and no spawned rank imports
JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_llm_scheduler_tpu.parallel.sharding import param_specs as jparam_specs
from k8s_llm_scheduler_tpu.parallel.sharding import shard_params as jshard_params
from k8s_llm_scheduler_tpu.train import train_step as jts
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.parallel import dryrun, launch
from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh

ttesting.cap_torch_threads()

_CFG = dict(name="train-par-test", vocab_size=64, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=128, max_seq_len=512, rope_theta=10000.0,
            tie_embeddings=True)
JCFG = jconfigs.LlamaConfig(**_CFG, dtype=jnp.float32)
TCFG = tconfigs.LlamaConfig(**_CFG, dtype=torch.float32)
B, S = 4, 64
LR = 1e-3
LAYOUTS = {
    "dp2": {"dp": 2},
    "fsdp2": {"fsdp": 2},
    "tp2": {"tp": 2},
    "sp2": {"sp": 2},
    "dp2-sp2-tp2": {"dp": 2, "sp": 2, "tp": 2},
    "dp2-fsdp2-tp2": {"dp": 2, "fsdp": 2, "tp": 2},
}


def _batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, JCFG.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([S, 40, S, 33], np.int32)
    starts = np.array([20, 9, 3, 0], np.int32)
    weights = rng.uniform(0.5, 3.0, size=(B, S)).astype(np.float32)
    return tokens, lens, starts, weights


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(3), JCFG))


def _jax_reference(axes, np_params, batch):
    """(loss, grads, AdamW params after) of the JAX step on `axes`."""
    mesh = jmake_mesh(axes)
    sgd = optax.sgd(1.0)
    _, step_fn = jts.make_train_step(JCFG, mesh, sgd)
    specs = jparam_specs(JCFG, tp="tp" if "tp" in axes else None,
                         fsdp="fsdp" if "fsdp" in axes else None)
    params = jshard_params(jax.tree_util.tree_map(jnp.asarray, np_params), mesh, specs)
    state = jts.TrainState(params, sgd.init(params), jnp.zeros((), jnp.int32))
    after, loss = step_fn(state, *step_fn.place_batch(*batch))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), np_params,
                                   jax.tree_util.tree_map(np.asarray, after.params))
    adamw = optax.adamw(LR)
    start = jax.tree_util.tree_map(jnp.asarray, np_params)
    updates, _ = adamw.update(jax.tree_util.tree_map(jnp.asarray, grads), adamw.init(start),
                              start)
    stepped = jax.tree_util.tree_map(np.asarray, optax.apply_updates(start, updates))
    return float(loss), _flat(grads), _flat(stepped)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_matches_the_jax_step_on_the_same_mesh(layout, np_params):
    axes = LAYOUTS[layout]
    batch = _batch()
    j_loss, j_grads, j_after = _jax_reference(axes, np_params, batch)
    got = launch.run_spmd(make_mesh(axes), dryrun.probe_step,
                          dict(cfg=TCFG, batch=batch, params=np_params, lr=LR, device="cpu"),
                          device="cpu")
    assert abs(got["loss"] - j_loss) <= 1e-5, (got["loss"], j_loss)
    grads, after = _flat(got["grads"]), _flat(got["params"])
    assert sorted(grads) == sorted(j_grads)
    flips = total = 0
    for name, want in j_grads.items():
        np.testing.assert_allclose(grads[name], want, rtol=1e-4, atol=1e-6, err_msg=name)
        off = np.abs(after[name] - j_after[name]) > 1e-3 * LR
        tiny = np.abs(want) < 1e-6
        assert not (off & ~tiny).any(), name
        flips += int((off & tiny).sum())
        total += want.size
    assert flips < 1e-3 * total
    assert got["replicated_equal"]
    # rank 0 is this test process, which holds both packages
    assert got["ranks_importing_jax"] == [0]


def test_sp_needs_ring_attention_and_pp_goes_to_the_pipeline():
    from k8s_llm_scheduler_tpu_torch.train.train_step import make_train_step

    bound = make_mesh({"sp": 2}).bind(None, 0, timeout_s=1.0)
    with pytest.raises(ValueError, match="ring attention"):
        make_train_step(TCFG, "cpu", mesh=bound, use_ring_attention=False)
    with pytest.raises(ValueError, match="ring attention needs"):
        make_train_step(TCFG, "cpu", use_ring_attention=True)
    with pytest.raises(ValueError, match="pipeline"):
        make_train_step(TCFG, "cpu", mesh=make_mesh({"pp": 2}).bind(None, 0, timeout_s=1.0))


def test_place_batch_gives_rows_and_columns_with_the_boundary_target():
    """dp x sp: rank (1, 1) holds rows 2-3 and columns 32-63 plus column
    64's stand-in (0 past the end); rank (0, 0)'s extra column is the next
    chunk's first token, the target of its last position."""
    from k8s_llm_scheduler_tpu_torch.train.train_step import make_train_step

    tokens, lens, starts, weights = _batch()
    for rank, rows, lo in ((0, slice(0, 2), 0), (3, slice(2, 4), 32)):
        m = make_mesh({"dp": 2, "sp": 2}).bind(None, rank, timeout_s=1.0)
        _, step_fn = make_train_step(TCFG, "cpu", mesh=m)
        t, ln, st, w = step_fn.place_batch(tokens, lens, starts, weights)
        want = np.concatenate([tokens, np.zeros((B, 1), np.int32)], 1)[rows, lo:lo + 33]
        np.testing.assert_array_equal(t.numpy(), want)
        np.testing.assert_array_equal(ln.numpy(), lens[rows])
        np.testing.assert_array_equal(st.numpy(), starts[rows])
        assert w.shape == (2, 33)
    with pytest.raises(ValueError, match="does not split"):
        step_fn.place_batch(tokens[:3], lens[:3])


def test_dryrun_multichip_on_eight_ranks():
    losses = dryrun.dryrun_multichip(8, device="cpu")
    assert sorted(losses) == ["dp_pp", "dp_sp_tp"]
    assert all(np.isfinite(v) for v in losses.values())


def test_dryrun_multihost_two_hosts_of_two_ranks():
    """tools/dryrun_multihost.py's parts 1-3 (tests/test_multihost.py:
    106-107): dp across the two hosts x tp within each trains a step from
    one global batch; each host serves a decision from its tp=2 replica;
    the coordinator alone binds."""
    outs = dryrun.dryrun_multihost(device="cpu", timeout_s=300.0)
    assert "dryrun OK (multihost train dp(DCN)=2 x tp(ICI)=2)" in outs[0]
    assert "coordinator-only bind" in outs[0]
    assert "no bind" in outs[1] and "bind:" not in outs[1]
