"""Pipeline-parallel (GPipe) training of the decision model (the port of the
JAX package's train/pipeline.py).

The trunk is split into `pp` stages: rank s of the pp axis holds the
contiguous block of layers [s*L/pp, (s+1)*L/pp). A batch goes through as
`n_micro` microbatches on the GPipe schedule: at tick t (of pp + n_micro -
1), stage s runs microbatch t - s and hands its output to stage s+1 by
`ppermute` around the pp ring. The last stage collects each finished
microbatch and computes the loss. The JAX package derives the backward by
autodiff of its scanned ticks; here the ticks' transpose is walked by hand
in reverse order: at tick t each stage receives the gradient of the output
it sent (the reverse permute of what stage s+1 found for its tick t+1
input) and backpropagates its tick's graph, so every rank issues the same
permutes in the same order. Each layer is recomputed in the backward
(torch.utils.checkpoint), as the one-device step does.

The tied embedding is used on stage 0 (the lookup) and on the last stage
(the LM head), `final_norm` on the last stage only; every rank holds them,
and their gradients are summed over pp so each copy takes the same update.
Composes with dp (the batch's rows). tp, sp and fsdp are refused, as the
JAX package refuses them (train/train_step.py trains those).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    _logits,
    _prefill_layer,
    _unbound_layers,
    init_params,
    rope_inv_freq,
)
from k8s_llm_scheduler_tpu_torch.train.train_step import (
    TrainState,
    _nll_sums,
    _place,
    _start_step,
    _state,
    _to_device,
    adamw,
    axes_of,
    mesh_device,
    reduce_grads,
)


def stage_params(params: Params, n_stages: int) -> Params:
    """Reshape the stacked layer tree [L, ...] -> [pp, L/pp, ...]."""
    L = params["layers"]["wq"].shape[0]
    if L % n_stages:
        raise ValueError(f"n_layers={L} not divisible by pp={n_stages}")
    out = dict(params)
    out["layers"] = {k: v.reshape(n_stages, L // n_stages, *v.shape[1:])
                     for k, v in params["layers"].items()}
    return out


def pp_specs(params: Params) -> Params:
    """The spec tree of a stage's params (parallel/sharding's notation):
    the layer stacks split over pp on their leading dim, the rest whole."""
    return {k: ({kk: ("pp",) + (None,) * (vv.dim() - 1) for kk, vv in v.items()}
                if k == "layers" else (None,) * v.dim())
            for k, v in params.items()}


def make_pp_train_step(
    cfg: LlamaConfig,
    mesh,
    device: str | torch.device = "cuda",
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    n_micro: int | None = None,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) with the trunk pipelined over `mesh`'s pp axis
    (size >= 2; `mesh` bound to this process's rank), optionally with dp.
    The local batch must divide into `n_micro` microbatches (default 2 *
    pp). The surface of train_step.make_train_step: init_fn(seed_or_params)
    (a whole tree, or a seed) -> TrainState of this rank's stage, step_fn(
    state, tokens, seq_lens) -> (state, loss) with the whole batch's loss on
    every rank, step_fn.place_batch(tokens, seq_lens) (the whole host batch
    -> this rank's dp rows), step_fn.gather_params and step_fn.specs."""
    from k8s_llm_scheduler_tpu_torch.parallel.sharding import unshard_params

    make_optimizer = optimizer or adamw()
    axes = dict(mesh.shape)
    n_stages = axes.get("pp", 1)
    if n_stages < 2:
        raise ValueError("make_pp_train_step needs a pp mesh axis of size >= 2")
    unsupported = [a for a in ("tp", "sp", "fsdp") if axes.get(a, 1) > 1]
    if unsupported:
        raise ValueError(
            f"pp composes with dp only; use train_step.make_train_step for {unsupported}")
    n_micro_ = n_micro or 2 * n_stages
    dev = mesh_device(mesh, device)
    stage, last = mesh.axis_index("pp"), n_stages - 1
    n_ticks = n_stages + n_micro_ - 1
    dp = axes.get("dp", 1)
    dp_index = mesh.axis_index("dp")
    loss_axes = axes_of(mesh, ("dp", "pp"))
    specs: dict = {}

    def init_fn(seed_or_params: int | Params = 0) -> TrainState:
        if isinstance(seed_or_params, dict):
            full = _to_device(seed_or_params, dev)
        else:
            full = init_params(cfg, seed=int(seed_or_params), device=dev)
        staged = stage_params(full, n_stages)
        local = {k: v for k, v in full.items() if k != "layers"}
        local["layers"] = {k: v[stage].clone() for k, v in staged["layers"].items()}
        specs.update(pp_specs(local))
        return _state(local, make_optimizer)

    def apply_stage(params, h, lens, positions, inv_freq):
        for lp in _unbound_layers(params["layers"], cfg.n_layers // n_stages):
            h, _, _ = checkpoint(_prefill_layer, lp, cfg, h, positions, lens, inv_freq,
                                 use_reentrant=False)
        return h

    def step_fn(state: TrainState, tokens, seq_lens):
        opt = _start_step(state, None)
        params = state.params
        Bl, S = tokens.shape
        if Bl % n_micro_:
            raise ValueError(f"local batch {Bl} not divisible by n_micro={n_micro_}")
        Bm = Bl // n_micro_
        group = mesh.group("pp")
        inv_freq = rope_inv_freq(cfg, dev)
        positions = torch.arange(S, device=dev).expand(Bm, S)
        micro_lens = seq_lens.reshape(n_micro_, Bm)
        D = cfg.d_model
        if stage == 0:
            x = params["embed"][tokens]
            micro_x = x.detach().reshape(n_micro_, Bm, S, D)
        zeros = torch.zeros((Bm, S, D), dtype=cfg.dtype, device=dev)
        # forward: stage s runs microbatch t - s at tick t
        ticks: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        outs: list = [None] * n_micro_
        buf = zeros
        for t in range(n_ticks):
            mb = t - stage
            send = zeros
            if 0 <= mb < n_micro_:
                x_in = (micro_x[mb] if stage == 0 else buf).detach().requires_grad_(True)
                h = apply_stage(params, x_in, micro_lens[mb], positions, inv_freq)
                ticks[t] = (x_in, h)
                send = h.detach()
                if stage == last:
                    outs[mb] = send.requires_grad_(True)
            if t + 1 < n_ticks:  # the last tick's hand-off is never read
                buf = group.permute(send, 1)
        # the loss: the whole batch's mean; every rank counts its targets
        den = (seq_lens.long() - 1).clamp(0, S - 1).sum().float()
        if dp > 1:
            den = mesh.group("dp").all_reduce(den)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        if stage == last:
            logits = _logits(params, cfg, torch.cat(outs))
            num, _ = _nll_sums(logits[:, :-1], tokens[:, 1:], seq_lens)
            del logits
            loss = num / torch.clamp(den, min=1.0)
            loss.backward()
        # backward: the ticks' transpose, in reverse order
        grad_in = zeros  # the gradient of this rank's tick t+1 input
        micro_grads: list = [zeros] * n_micro_
        for t in reversed(range(n_ticks)):
            mb = t - stage
            grad_h = group.permute(grad_in, -1) if t + 1 < n_ticks else zeros
            grad_in = zeros
            if t in ticks:
                x_in, h = ticks.pop(t)
                if stage == last:
                    grad_h = grad_h + outs[mb].grad
                torch.autograd.backward(h, grad_h)
                if stage == 0:
                    micro_grads[mb] = x_in.grad
                else:
                    grad_in = x_in.grad
        if stage == 0:
            x.backward(torch.stack(micro_grads).reshape(Bl, S, D))
        reduce_grads(mesh, params, specs, loss_axes)
        opt.step()
        loss = loss.detach().clone()
        if loss_axes:
            loss = mesh.group(loss_axes).all_reduce(loss)
        return TrainState(params, opt, state.step + 1), loss

    def place_batch(tokens, seq_lens):
        tokens = np.asarray(tokens)
        B = tokens.shape[0]
        if B % dp:
            raise ValueError(f"batch of {B} rows does not split over dp={dp}")
        rows = slice(dp_index * (B // dp), (dp_index + 1) * (B // dp))
        return _place(dev, tokens[rows], np.asarray(seq_lens)[rows])

    step_fn.place_batch = place_batch  # type: ignore[attr-defined]
    step_fn.gather_params = lambda params: unshard_params(params, mesh, specs)  # type: ignore[attr-defined]
    step_fn.specs = specs  # type: ignore[attr-defined]
    return init_fn, step_fn

