"""The port's checkpoint loader held against the JAX package's on the CPU:
a small HF-layout Llama checkpoint written with the `safetensors` package
(one file, or shards under an index) is read by the port's own reader of
the format to the same arrays, and `load_hf_checkpoint` gives params
bit for bit equal to the JAX loader's (through models/convert.
params_from_jax), in f32 and bf16, plain and int8, with tied and untied
heads. Native save/restore round-trips, and a truncated file or a wrong
shape raises, naming the tensor."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import loader as jloader
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models import loader as tloader
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.quant import quantize_params
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

SHAPE = dict(d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=512,
             rope_theta=10000.0)


def cfgs(dtype: str, tied: bool):
    kw = dict(name=f"loader-{dtype}-{tied}", vocab_size=512 if tied else 256,
              tie_embeddings=tied, **SHAPE)
    return (jconfigs.LlamaConfig(**kw, dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]),
            tconfigs.LlamaConfig(**kw, dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype]))


def hf_state_dict(cfg, seed=0) -> dict[str, torch.Tensor]:
    """A synthetic HF-layout state dict (f32, numpy draws from a seed)."""
    rng = np.random.default_rng(seed)
    hd, D, F = cfg.head_dim, cfg.d_model, cfg.d_ff
    sd = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = (cfg.vocab_size, D)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": (D,),
                   p + "self_attn.q_proj.weight": (cfg.n_heads * hd, D),
                   p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, D),
                   p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, D),
                   p + "self_attn.o_proj.weight": (D, cfg.n_heads * hd),
                   p + "post_attention_layernorm.weight": (D,),
                   p + "mlp.gate_proj.weight": (F, D),
                   p + "mlp.up_proj.weight": (F, D),
                   p + "mlp.down_proj.weight": (D, F)})
    return {k: torch.from_numpy((rng.normal(size=s) * 0.02).astype(np.float32))
            for k, s in sd.items()}


def write_ckpt(path, sd, shards=1):
    from safetensors.torch import save_file

    names = sorted(sd)
    if shards == 1:
        save_file(sd, str(path / "model.safetensors"))
        return path
    per = -(-len(names) // shards)
    weight_map = {}
    for s in range(shards):
        part = {n: sd[n] for n in names[s * per:(s + 1) * per]}
        fname = f"model-{s:05d}-of-{shards:05d}.safetensors"
        save_file(part, str(path / fname))
        weight_map.update({n: fname for n in part})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return path


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_bitwise(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


CASES = [(d, q, t, 1) for d in ("f32", "bf16") for q in (None, "int8") for t in (True, False)]
CASES += [("bf16", None, False, 3), ("bf16", "int8", True, 3)]


@pytest.mark.parametrize("dtype,quantize,tied,shards", CASES,
                         ids=[f"{d}-{q or 'plain'}-{'tied' if t else 'untied'}-{s}shard"
                              for d, q, t, s in CASES])
def test_load_hf_checkpoint_equals_the_jax_loader_bit_for_bit(tmp_path, dtype, quantize,
                                                              tied, shards):
    jcfg, tcfg = cfgs(dtype, tied)
    sd = hf_state_dict(tcfg)
    if dtype == "bf16" and shards == 1:
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}  # a BF16 file
    write_ckpt(tmp_path, sd, shards)
    want = params_from_jax(_np_tree(jloader.load_hf_checkpoint(tmp_path, jcfg, quantize=quantize)),
                           device="cpu")
    got = tloader.load_hf_checkpoint(tmp_path, tcfg, device="cpu", quantize=quantize)
    _assert_bitwise(got, want)
    assert ("lm_head" in got) == (not tied)
    assert [p.name for p in tloader.checkpoint_files(tmp_path)] == [
        p.name for p in jloader.checkpoint_files(tmp_path)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8,
                                   torch.int32, torch.int64, torch.uint8],
                         ids=lambda d: str(d).split(".")[-1])
def test_the_format_reader_gives_the_safetensors_arrays(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(3)
    tensors = {f"t{i}": (torch.randn(shape, generator=g) * 50).to(dtype)
               for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (0, 4), ()])}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    f = tloader.SafetensorsFile(tmp_path / "x.safetensors")
    with safe_open(str(tmp_path / "x.safetensors"), framework="pt") as ref:
        assert sorted(f.keys()) == sorted(ref.keys())
        for name in ref.keys():
            got, want = f.get_tensor(name), ref.get_tensor(name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), name


def test_a_truncated_file_raises_naming_the_tensor(tmp_path):
    jcfg, tcfg = cfgs("f32", True)
    write_ckpt(tmp_path, hf_state_dict(tcfg))
    path = tmp_path / "model.safetensors"
    last = tloader.SafetensorsFile(path).keys()[-1]
    data = path.read_bytes()
    path.write_bytes(data[:-10])
    with pytest.raises(ValueError, match=rf"{last}.*truncated"):
        tloader.load_hf_checkpoint(tmp_path, tcfg, device="cpu")
    path.write_bytes(data[:4])
    with pytest.raises(ValueError, match="not a safetensors file"):
        tloader.SafetensorsFile(path)


def test_a_wrong_shape_raises_naming_the_tensor(tmp_path):
    _, tcfg = cfgs("f32", False)
    sd = hf_state_dict(tcfg)
    sd["model.layers.1.mlp.up_proj.weight"] = sd["model.layers.1.mlp.up_proj.weight"][:, :-1].contiguous()
    write_ckpt(tmp_path, sd)
    with pytest.raises(ValueError, match=r"model\.layers\.1\.mlp\.up_proj\.weight: shape"):
        tloader.load_hf_checkpoint(tmp_path, tcfg, device="cpu")


def test_a_missing_layer_raises(tmp_path):
    _, tcfg = cfgs("f32", False)
    sd = {k: v for k, v in hf_state_dict(tcfg).items() if not k.startswith("model.layers.2.")}
    write_ckpt(tmp_path, sd)
    with pytest.raises(ValueError, match="partial layer stacks"):
        tloader.load_hf_checkpoint(tmp_path, tcfg, device="cpu")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_save_restore_round_trips(tmp_path, quant):
    _, tcfg = cfgs("bf16", False)
    (tmp_path / "hf").mkdir()
    write_ckpt(tmp_path / "hf", hf_state_dict(tcfg))
    params = tloader.load_hf_checkpoint(tmp_path / "hf", tcfg, device="cpu")
    if quant:
        params = quantize_params(params)
    tloader.save_checkpoint(tmp_path / "native", params)
    tloader.save_checkpoint(tmp_path / "native", params)  # overwrites in place
    _assert_bitwise(tloader.restore_checkpoint(tmp_path / "native", tcfg, device="cpu"), params)
    assert not (tmp_path / "native.saving").exists() and not (tmp_path / "native.old").exists()


def test_restore_refuses_a_foreign_or_misshapen_checkpoint(tmp_path):
    _, tcfg = cfgs("bf16", False)
    _, other = cfgs("bf16", True)
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(tloader.CheckpointError, match="orbax"):
        tloader.restore_checkpoint(tmp_path / "orbax", tcfg, device="cpu")
    with pytest.raises(tloader.CheckpointError, match="does not exist"):
        tloader.restore_checkpoint(tmp_path / "absent", tcfg, device="cpu")
    (tmp_path / "hf").mkdir()
    write_ckpt(tmp_path / "hf", hf_state_dict(other))
    tloader.save_checkpoint(tmp_path / "native",
                            tloader.load_hf_checkpoint(tmp_path / "hf", other, device="cpu"))
    with pytest.raises(tloader.CheckpointError, match="'embed' has shape"):
        tloader.restore_checkpoint(tmp_path / "native", tcfg, device="cpu")
