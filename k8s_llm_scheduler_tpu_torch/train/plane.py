"""The training plane: how one rank of a training mesh holds its share of
the model, and the differentiable collectives that join the shares
(parallel/collectives.py).

The JAX train step hands GSPMD the shardings of parallel/sharding.py and
XLA inserts the collectives and their transposes. Here each rank is a
process holding its block of each leaf, and the model's forwards
(models/llama.py) call the plane's hooks, as they call the serving plane's
(engine/sharded/plane.py):

- tp (Megatron): `column_input` before each column-parallel product
  (identity forward, the input's gradient summed over tp backward);
  `row_dense` after each row-parallel one (f32 partials summed over tp
  forward, identity backward); `embed_lookup` a masked lookup in the
  rank's vocab block summed over tp; `gather_logits` the rank's vocab
  block of the logits into the whole vocab, the gradient's block back
  (forward_prefill's logits; the train step's loss reduces over the vocab
  split instead, train_step._vocab_parallel_nll).
- fsdp (ZeRO-3): `layer_weights` all-gathers a layer's fsdp-split weights
  inside the recomputed layer (so they live one layer at a time; the
  backward issues the gathers again, then reduce-scatters the weights'
  gradients), `head_weight` an untied lm_head's.
At tp 1 the tp hooks issue no collective, and at fsdp 1 nothing is
gathered: a dp- or sp-only mesh runs the one-device forward.
"""

from __future__ import annotations

import dataclasses

import torch

from k8s_llm_scheduler_tpu_torch.engine.sharded.plane import RankConfig
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.parallel.collectives import (
    all_gather,
    copy_to_tp,
    gather_vocab,
    reduce_from_tp,
)

Params = dict


class TrainingPlane:
    """A training rank's plane over `mesh` (bound to the rank), for the
    param `specs` of parallel/sharding.param_specs."""

    def __init__(self, mesh, specs: Params) -> None:
        self.mesh, self.specs = mesh, specs
        self.tp = int(mesh.shape.get("tp", 1))
        self.fsdp = int(mesh.shape.get("fsdp", 1))

    def __repr__(self) -> str:
        return f"TrainingPlane({self.mesh.shape}, rank={self.mesh.rank})"

    def local_config(self, cfg: LlamaConfig) -> RankConfig:
        """The rank's geometry: heads, kv heads and d_ff divided by tp,
        head_dim and the vocab the model's; the plane rides along."""
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LlamaConfig)}
        fields.update(n_heads=cfg.n_heads // self.tp, n_kv_heads=cfg.n_kv_heads // self.tp,
                      d_ff=cfg.d_ff // self.tp)
        return RankConfig(**fields, rank_head_dim=cfg.head_dim, plane=self)

    # ------------------------------------------------------------------ tp
    def column_input(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else copy_to_tp(x, self.mesh.group("tp"))

    def row_dense(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., in/tp] @ w [in/tp, out] summed over tp: f32 partials,
        rounded once to x's dtype. At tp 1 the one-device product."""
        from k8s_llm_scheduler_tpu_torch.models.llama import _matmul_f32

        if self.tp == 1:
            return torch.matmul(x, w)
        return reduce_from_tp(_matmul_f32(x, w), self.mesh.group("tp")).to(x.dtype)

    def embed_lookup(self, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return embed[tokens]
        block = embed.shape[0]
        local = tokens.long() - self.mesh.axis_index("tp") * block
        hit = (local >= 0) & (local < block)
        rows = embed[local.clamp(0, block - 1)] * hit[..., None].to(embed.dtype)
        return reduce_from_tp(rows, self.mesh.group("tp"))

    def gather_logits(self, local: torch.Tensor) -> torch.Tensor:
        return local if self.tp == 1 else gather_vocab(local, self.mesh.group("tp"))

    # ---------------------------------------------------------------- fsdp
    def _gather(self, w: torch.Tensor, spec: tuple) -> torch.Tensor:
        if self.fsdp == 1 or "fsdp" not in spec:
            return w
        return all_gather(w, self.mesh.group("fsdp"), spec.index("fsdp"))

    def layer_weights(self, lp: Params) -> Params:
        """A layer's weights (views of the stacks) with each fsdp-split one
        gathered; the stacked spec's leading L is not a dim of the view."""
        layer_specs = self.specs["layers"]
        return {k: self._gather(w, layer_specs[k][1:]) for k, w in lp.items()}

    def head_weight(self, w: torch.Tensor) -> torch.Tensor:
        return self._gather(w, self.specs["lm_head"])
