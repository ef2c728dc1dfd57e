"""The causal-LM training step of the decision model on one device.

The port of the JAX package's train/train_step.py. The loss is the same
answer-masked, re-weighted next-token cross entropy; the step recomputes
each layer in the backward (`forward_prefill(..., remat=True)`, the
torch.utils.checkpoint counterpart of the JAX step's jax.checkpoint) and
updates with torch.optim.AdamW at the JAX default's settings (optax.adamw:
betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4; torch's own default decay
is 1e-2). Parameters are updated in place, so the state a step returns
holds the same tensors it was given.

The JAX step's mesh axes (dp, fsdp, tp, sp) and its ring attention are not
ported: asking for them raises, naming ROADMAP queue 1 item 9c, and so does
the pipeline-parallel trainer (train/pipeline.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import Params, forward_prefill, init_params

ADAMW_DEFAULTS = {"lr": 1e-5, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


class TrainState(NamedTuple):
    params: Params
    optimizer: torch.optim.Optimizer
    step: int


def adamw(lr: float = ADAMW_DEFAULTS["lr"]) -> Callable[[list], torch.optim.Optimizer]:
    """An optimizer factory: torch.optim.AdamW over the given tensors at
    optax.adamw's settings and learning rate `lr`."""
    return lambda tensors: torch.optim.AdamW(tensors, **{**ADAMW_DEFAULTS, "lr": lr})


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The tree's tensors in a fixed order (sorted keys, depth first)."""
    out = []
    for key in sorted(params):
        node = params[key]
        out.extend(param_leaves(node) if isinstance(node, dict) else [node])
    return out


def causal_lm_loss(
    logits: torch.Tensor,  # [B, S, V] f32
    tokens: torch.Tensor,  # [B, S]
    seq_lens: torch.Tensor,  # [B]
    loss_start: torch.Tensor | None = None,  # [B]
    loss_weights: torch.Tensor | None = None,  # [B, S] f32
) -> torch.Tensor:
    """Mean next-token cross entropy over valid (non-pad) positions.

    `loss_start` restricts the loss to targets at index >= loss_start: the
    distillation path passes the answer offset, so the gradient teaches the
    decision rather than the 25x longer prompt. Target j predicts token
    j+1, so the answer's tokens count from j = loss_start - 1.
    `loss_weights` (aligned with `tokens`: the weight of predicting token j)
    re-weights positions inside the mask; the mean is normalised by the
    weights' sum, so upweighting the node name keeps the loss's scale."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    S = targets.shape[1]
    pos = torch.arange(S, device=logits.device)[None, :]
    mask = pos < (seq_lens[:, None] - 1)
    if loss_start is not None:
        mask = mask & (pos >= torch.clamp(loss_start[:, None] - 1, min=0))
    mask = mask.float()
    if loss_weights is not None:
        mask = mask * loss_weights[:, 1:]
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def refuse_mesh(mesh_axes: dict | None, use_ring_attention: bool = False) -> None:
    """Raise for the JAX step's parallel layouts, which the port lacks."""
    wide = {ax: n for ax, n in (mesh_axes or {}).items() if int(n) > 1}
    if wide or use_ring_attention:
        raise NotImplementedError(
            f"mesh {wide or mesh_axes}{' with ring attention' if use_ring_attention else ''}: "
            f"the port trains on one device (dp/fsdp/tp/sp layouts, ring attention "
            f"and the pipeline trainer: ROADMAP queue 1 item 9c)"
        )


def make_train_step(
    cfg: LlamaConfig,
    device: str | torch.device = "cuda",
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    lr_schedule: Callable[[int], float] | None = None,
    *,
    mesh_axes: dict | None = None,
    use_ring_attention: bool = False,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) on `device`.

    init_fn(seed_or_params) -> TrainState: the port's init_params from a
    seed, or a params tree (models/convert.params_from_jax's, or a restored
    checkpoint's) moved onto the device (a tensor already there is trained
    in place); every floating leaf then requires grad, and `optimizer` (a
    factory over the leaves; default adamw(1e-5)) holds the moments, in
    the params' dtype as optax keeps them.

    step_fn(state, tokens, seq_lens, loss_start=None, loss_weights=None)
    -> (state, loss): one AdamW update from the loss of a recomputing
    forward; `loss` is a 0-dim f32 tensor on the device, read by the caller
    when it wants it (no host sync in the step). `lr_schedule(n)`, when
    given, sets the learning rate of the n-th update (n from 0), as an
    optax schedule is evaluated at the update count.
    step_fn.place_batch(tokens, seq_lens, loss_start=None, loss_weights=None)
    moves a host batch (numpy) onto the device, returning as many tensors
    as it was given."""
    refuse_mesh(mesh_axes, use_ring_attention)
    dev = resolve_device(device)
    make_optimizer = optimizer or adamw()

    def init_fn(seed_or_params: int | Params = 0) -> TrainState:
        if isinstance(seed_or_params, dict):
            params = _to_device(seed_or_params, dev)
        else:
            params = init_params(cfg, seed=int(seed_or_params), device=dev)
        leaves = [t for t in param_leaves(params) if t.is_floating_point()]
        for t in leaves:
            t.requires_grad_(True)
        return TrainState(params, make_optimizer(leaves), 0)

    def step_fn(state: TrainState, tokens, seq_lens, loss_start=None, loss_weights=None):
        opt = state.optimizer
        if lr_schedule is not None:
            lr = float(lr_schedule(state.step))
            for group in opt.param_groups:
                group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        logits, _, _ = forward_prefill(state.params, cfg, tokens, seq_lens, remat=True)
        loss = causal_lm_loss(logits, tokens, seq_lens, loss_start, loss_weights)
        del logits
        loss.backward()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    def place_batch(tokens, seq_lens, loss_start=None, loss_weights=None):
        placed = [torch.as_tensor(tokens).to(dev, torch.long),
                  torch.as_tensor(seq_lens).to(dev, torch.int32)]
        if loss_start is not None:
            placed.append(torch.as_tensor(loss_start).to(dev, torch.int32))
        if loss_weights is not None:
            placed.append(torch.as_tensor(loss_weights).to(dev, torch.float32))
        return tuple(placed)

    step_fn.place_batch = place_batch  # type: ignore[attr-defined]
    return init_fn, step_fn


def _to_device(tree: Params, dev: torch.device) -> Params:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)
