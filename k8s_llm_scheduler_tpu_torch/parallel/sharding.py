"""Megatron partition specs for the Llama param tree and the KV cache
(after the JAX package's parallel/sharding.py), each rank's slice, and
the whole tree gathered back from the slices.

A spec is a tuple with one entry per tensor dim: an axis name where that
dim is split over the axis, None where it is whole (the JAX package's
PartitionSpec, as a plain tuple):

- wq/wk/wv shard the head (output) dim over tp  -> column parallel
- wo shards the head (input) dim over tp        -> row parallel, all-reduce after
- w_gate/w_up shard d_ff over tp                -> column parallel
- w_down shards d_ff (input) over tp            -> row parallel, all-reduce after
- the embedding and an untied lm_head shard the vocab dim
- norms are replicated
- with an fsdp axis (training), each projection also splits its other
  weight dim over fsdp (ZeRO-3), so a leaf may split two dims

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


def shard_dims(spec: Spec) -> list[int]:
    """The split dims of `spec` (none for a replicated leaf; fsdp + tp
    leaves split two)."""
    return [i for i, ax in enumerate(spec) if ax is not None]


def shard_ranges(shape: tuple[int, ...], spec: Spec, mesh,
                 rank: int | None = None) -> list[tuple[int, int, int]]:
    """[(dim, lo, hi)]: `rank`'s block of each split dim of a leaf of
    global `shape` whose axis is wider than 1 (the mesh's bound rank by
    default)."""
    out = []
    for dim in shard_dims(spec):
        n = mesh.shape.get(spec[dim], 1)
        if n == 1:
            continue
        size = shape[dim]
        if size % n:
            raise ValueError(f"dim of {size} does not split over {spec[dim]}={n}")
        i = mesh.axis_index(spec[dim], rank)
        out.append((dim, i * (size // n), (i + 1) * (size // n)))
    return out


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
    by default): each split leaf narrowed on every split dim and copied,
    replicated leaves shared with the full tree."""
    if specs is None:
        assert cfg is not None, "need cfg to derive specs"
        specs = param_specs(cfg)

    def take(t: torch.Tensor, spec: Spec, path: str) -> torch.Tensor:
        ranges = shard_ranges(tuple(t.shape), spec, mesh, rank)
        for dim, lo, hi in ranges:
            t = t.narrow(dim, lo, hi - lo)
        return t.contiguous() if ranges else t

    return _walk(params, specs, take)


@torch.no_grad()
def unshard_params(params: Params, mesh, specs: Params) -> Params:
    """The whole tree from every rank's slice (shard_params's inverse):
    each split leaf all-gathered along each of its split dims over that
    axis's group. A collective: every rank of the mesh calls it, in the
    same order, and each gets the whole tree."""

    def gather(t: torch.Tensor, spec: Spec, path: str) -> torch.Tensor:
        for dim in shard_dims(spec):
            if mesh.shape.get(spec[dim], 1) > 1:
                t = mesh.group(spec[dim]).all_gather(t.detach(), dim)
        return t

    return _walk(params, specs, gather)


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
        ranges = shard_ranges(shape, spec, mesh, rank)
        if ranges:
            (out[name],) = ranges
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
