"""The tensor-parallel serving plane (after the JAX package's
engine/sharded/plane.py): one place that knows how a rank's share of the
model and of the engine's state is laid out, and the collectives that
join the shares.

The JAX plane hands GSPMD the shardings and lets XLA insert the
collectives. Here each rank is a process holding its contiguous block of
heads (parallel/sharding.py), so `ServingPlane` hands out:

- the LOCAL GEOMETRY (`local_config`): heads, kv heads and d_ff divided by
  tp, head_dim kept. It is a LlamaConfig whose reshapes and buffers are the
  rank's: every buffer the engine sizes from `cfg.n_kv_heads` holds the
  rank's kv heads, and the attention kernels (K1, K2, K4) run on the rank's
  heads unchanged. It also carries the plane, which is how the model's
  forwards (models/llama.py) find the collectives below;
- `row_dense`: a row-parallel projection (wo, w_down): each rank's partial
  product in f32, summed over the group, rounded once to the activation
  dtype, so a bf16 tp>1 product has the one rounding of tp=1's matmul;
- `embed_lookup`: the vocab-sharded embedding: each rank looks up the ids
  in its vocab block (zeros elsewhere) and the group sums;
- `gather_logits`: vocab-sharded logits into [rows, V] on every rank, as an
  all-reduce of a zero-filled buffer each rank fills at its own block (one
  non-zero contributor per element: exact);
- `place_params` / `serving_param_specs`: a rank's slice of a full tree,
  int8 pairs included (q shards like its weight, the [L, 1, out] scale on
  the output axis only).

At tp 1 there is no plane (`build_plane` returns None) and the model's
forwards issue no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.quant import QUANT_KEYS
from k8s_llm_scheduler_tpu_torch.parallel.sharding import (
    kv_cache_spec,
    param_specs,
    shard_params,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RankConfig(LlamaConfig):
    """One tp rank's view of the model: n_heads, n_kv_heads and d_ff are
    the rank's, head_dim the model's (LlamaConfig.head_dim derives it from
    d_model // n_heads, which the rank's head count would double), and the
    vocab the model's (logits are gathered). `plane` joins the ranks."""

    rank_head_dim: int = 0
    plane: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.rank_head_dim


def serving_param_specs(cfg: LlamaConfig, *, quantized: bool = False, tp: str = "tp"):
    """param_specs over the int8 `{"q", "scale"}` leaves (models/quant.py):
    q keeps the dense weight's spec, the per-output-channel scale [L, 1,
    out] shards on the output axis only."""
    specs = param_specs(cfg, tp=tp, fsdp=None)
    if not quantized:
        return specs
    layers = dict(specs["layers"])
    for key in QUANT_KEYS:
        parts = tuple(layers[key])
        layers[key] = {"q": layers[key], "scale": (*parts[:-2], None, parts[-1])}
    return {**specs, "layers": layers}


class ServingPlane:
    """A rank's tensor-parallel plane over `mesh`'s `tp_axis`."""

    def __init__(self, mesh, tp_axis: str = "tp") -> None:
        self.mesh = mesh
        self.tp_axis = tp_axis

    def __repr__(self) -> str:
        return f"ServingPlane(tp={self.tp}, rank={self.rank})"

    @property
    def tp(self) -> int:
        return int(self.mesh.shape.get(self.tp_axis, 1))

    @property
    def rank(self) -> int:
        """This process's index in its tp group."""
        return self.mesh.axis_index(self.tp_axis)

    @property
    def group(self):
        """The tp group (parallel/launch.AxisGroup), created at first use."""
        return self.mesh.group(self.tp_axis)

    @property
    def backend(self) -> str:
        """"nccl" or "gloo", by parallel/launch.choose_backend's rule."""
        from k8s_llm_scheduler_tpu_torch.parallel.launch import choose_backend

        ranks = self.mesh.axis_ranks(self.tp_axis)
        return choose_backend([self.mesh.local_device_index(r) for r in ranks])

    # ----------------------------------------------------------- geometry
    def local_config(self, cfg: LlamaConfig) -> RankConfig:
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LlamaConfig)}
        fields.update(n_heads=cfg.n_heads // self.tp, n_kv_heads=cfg.n_kv_heads // self.tp,
                      d_ff=cfg.d_ff // self.tp)
        return RankConfig(**fields, rank_head_dim=cfg.head_dim, plane=self)

    def vocab_range(self, vocab: int) -> tuple[int, int]:
        """[lo, hi) of the vocab ids this rank's embedding block holds."""
        block = vocab // self.tp
        return self.rank * block, (self.rank + 1) * block

    # -------------------------------------------------------- collectives
    def reduce(self, partial: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Sum f32 partials over the group, then round once to `dtype`."""
        return self.group.all_reduce(partial.float().contiguous()).to(dtype)

    def row_dense(self, x: torch.Tensor, w) -> torch.Tensor:
        """A row-parallel projection: x [..., in/tp] @ w [in/tp, out] summed
        over the group. An int8 pair's per-output scale (whole on every
        rank) applies after the sum."""
        from k8s_llm_scheduler_tpu_torch.models.llama import _matmul_f32

        if isinstance(w, dict):
            total = self.group.all_reduce(_matmul_f32(x, w["q"].to(x.dtype)).contiguous())
            return (total * w["scale"]).to(x.dtype)
        return self.reduce(_matmul_f32(x, w), x.dtype)

    def embed_lookup(self, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the vocab-sharded embedding for `tokens`, on every rank."""
        lo, hi = self.vocab_range(embed.shape[0] * self.tp)
        local = tokens.long() - lo
        hit = (local >= 0) & (local < hi - lo)
        rows = embed[local.clamp(0, hi - lo - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
        return self.group.all_reduce(rows.contiguous())

    def gather_logits(self, local: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] f32 logits of this rank's vocab block -> [..., V]."""
        vocab = local.shape[-1] * self.tp
        lo, hi = self.vocab_range(vocab)
        full = torch.zeros((*local.shape[:-1], vocab), dtype=torch.float32,
                           device=local.device)
        full[..., lo:hi] = local
        return self.group.all_reduce(full)

    # The training plane's hooks (train/plane.py), which serving leaves as
    # they are: no gradient flows here, and serving never splits over fsdp.
    def column_input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def layer_weights(self, lp: Params) -> Params:
        return lp

    def head_weight(self, w):
        return w

    # ------------------------------------------------------------- params
    def kv_spec(self) -> tuple:
        """Paged KV `[L, pages, page, n_kv, hd]` (parallel/sharding.py)."""
        return kv_cache_spec(self.tp_axis)

    def place_params(self, params: Params, cfg: LlamaConfig, *, quantized: bool = False,
                     rank: int | None = None) -> Params:
        """This rank's (or global `rank`'s) slice of a full, possibly int8,
        param tree."""
        specs = serving_param_specs(cfg, quantized=quantized, tp=self.tp_axis)
        return shard_params(params, self.mesh, rank, specs)


def build_plane(mesh, tp_axis: str = "tp") -> ServingPlane | None:
    """The engine's constructor hook: a plane iff the mesh has a tp axis
    wider than 1; single-device and tp=1 meshes serve unsharded (None)."""
    if mesh is None or int(mesh.shape.get(tp_axis, 1)) <= 1:
        return None
    return ServingPlane(mesh, tp_axis)
