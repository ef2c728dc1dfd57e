"""Megatron partition specs for the Llama param tree and the KV cache
(after the JAX package's parallel/sharding.py), and each rank's slice.

A spec is a tuple with one entry per tensor dim: an axis name where that
dim is split over the axis, None where it is whole (the JAX package's
PartitionSpec, as a plain tuple):

- wq/wk/wv shard the head (output) dim over tp  -> column parallel
- wo shards the head (input) dim over tp        -> row parallel, all-reduce after
- w_gate/w_up shard d_ff over tp                -> column parallel
- w_down shards d_ff (input) over tp            -> row parallel, all-reduce after
- the embedding and an untied lm_head shard the vocab dim
- norms are replicated

The stacked-layer leading axis (L) is never sharded. KV caches shard the
kv-head dim. Rank r of a tp group holds the contiguous r-th block of each
split dim, so its q heads [r*H/tp, (r+1)*H/tp) and kv heads
[r*KV/tp, ...) keep GQA's group map inside the rank.
"""

from __future__ import annotations

from typing import Any

import torch

from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig

Params = dict[str, Any]
Spec = tuple


def param_specs(cfg: LlamaConfig, tp: str | None = "tp", fsdp: str | None = None) -> Params:
    """The spec tree matching models.llama.init_params's structure."""
    specs: Params = {
        "embed": (tp, None),
        "final_norm": (None,),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, fsdp, tp),
            "wk": (None, fsdp, tp),
            "wv": (None, fsdp, tp),
            "wo": (None, tp, fsdp),
            "mlp_norm": (None, None),
            "w_gate": (None, fsdp, tp),
            "w_up": (None, fsdp, tp),
            "w_down": (None, tp, fsdp),
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fsdp, tp)
    return specs


def kv_cache_spec(tp: str | None = "tp") -> Spec:
    """[L, num_pages, page_size, n_kv, hd]: kv heads shard over tp."""
    return (None, None, None, tp, None)


def shard_dim(spec: Spec) -> int | None:
    """The one split dim of `spec` (None for a replicated leaf)."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim")
    return dims[0] if dims else None


def shard_range(size: int, spec: Spec, mesh, rank: int | None = None):
    """(dim, lo, hi): `rank`'s block of the split dim of a leaf whose split
    dim has `size` entries; None for a replicated leaf."""
    dim = shard_dim(spec)
    if dim is None:
        return None
    n = mesh.shape.get(spec[dim], 1)
    if n == 1:
        return None
    if size % n:
        raise ValueError(f"dim of {size} does not split over {spec[dim]}={n}")
    i = mesh.axis_index(spec[dim], rank)
    return dim, i * (size // n), (i + 1) * (size // n)


def shard_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape each rank holds of a leaf of global `shape`."""
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is not None:
            out[i] //= mesh.shape.get(ax, 1)
    return tuple(out)


def _walk(params, specs, fn, path=""):
    if isinstance(params, dict):
        return {k: _walk(params[k], specs[k], fn, f"{path}.{k}" if path else k)
                for k in params}
    return fn(params, specs, path)


def shard_params(params: Params, mesh, rank: int | None = None, specs: Params | None = None,
                 cfg: LlamaConfig | None = None) -> Params:
    """`rank`'s contiguous slice of a full param tree (the mesh's bound rank
    by default): each split leaf narrowed and copied, replicated leaves
    shared with the full tree."""
    if specs is None:
        assert cfg is not None, "need cfg to derive specs"
        specs = param_specs(cfg)

    def take(t: torch.Tensor, spec: Spec, path: str) -> torch.Tensor:
        dim = shard_dim(spec)
        rng = None if dim is None else shard_range(t.shape[dim], spec, mesh, rank)
        if rng is None:
            return t
        dim, lo, hi = rng
        return t.narrow(dim, lo, hi - lo).contiguous()

    return _walk(params, specs, take)


def rank_ranges(cfg: LlamaConfig, mesh, rank: int | None = None, tp: str = "tp") -> dict:
    """{param name: (dim, lo, hi)}: `rank`'s block of every tp-split param,
    by the flat names of models/loader's shape table (models/llama.
    init_params's and models/loader.load_hf_checkpoint's `shard`)."""
    from k8s_llm_scheduler_tpu_torch.models.loader import _expected_shapes

    specs = param_specs(cfg, tp=tp)
    out = {}
    for name, shape in _expected_shapes(cfg).items():
        spec = specs
        for part in name.split("."):
            spec = spec[part]
        dim = shard_dim(spec)
        rng = None if dim is None else shard_range(shape[dim], spec, mesh, rank)
        if rng is not None:
            out[name] = rng
    return out


def validate_specs_divisibility(cfg: LlamaConfig, mesh, tp: str = "tp") -> None:
    """The tp axis must divide heads, kv heads, d_ff and the vocab: raise
    early with the JAX package's message."""
    size = mesh.shape.get(tp, 1)
    problems = []
    if cfg.n_heads % size:
        problems.append(f"n_heads={cfg.n_heads} % tp={size}")
    if cfg.n_kv_heads % size:
        problems.append(f"n_kv_heads={cfg.n_kv_heads} % tp={size}")
    if cfg.d_ff % size:
        problems.append(f"d_ff={cfg.d_ff} % tp={size}")
    if cfg.vocab_size % size:
        problems.append(f"vocab={cfg.vocab_size} % tp={size}")
    if problems:
        raise ValueError(f"model {cfg.name} not divisible by tp axis: {problems}")
