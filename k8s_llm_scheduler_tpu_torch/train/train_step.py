"""The causal-LM training step of the decision model, on one device or a
rank mesh (the port of the JAX package's train/train_step.py).

The loss is the same answer-masked, re-weighted next-token cross entropy;
the step recomputes each layer in the backward (`forward_prefill(...,
remat=True)`, the torch.utils.checkpoint counterpart of the JAX step's
jax.checkpoint) and updates with torch.optim.AdamW at the JAX default's
settings (optax.adamw: betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4;
torch's own default decay is 1e-2). Parameters are updated in place, so
the state a step returns holds the same tensors it was given.

On a mesh (parallel/mesh.RankMesh, bound to this process's rank) every
rank runs the same step on its share, with the JAX step's axes:

    dp    the batch's rows
    fsdp  each projection's other weight dim (ZeRO-3: train/plane.py
          gathers a layer's weights inside the recomputed layer); the
          batch's rows are split over fsdp too, as ZeRO-3's data parallel
          ranks do (the JAX step replicates them there; the gradient is the
          same sum)
    tp    Megatron column/row splits (parallel/sharding.param_specs); the
          loss reduces the log-softmax over the vocab split, as GSPMD does,
          never gathering the [B, S, V] logits
    sp    the sequence, through ring attention (parallel/ring_attention.py)

The loss is the whole batch's: sum(nll * mask) / sum(mask) over every row
and position of every rank. Each rank backpropagates its own sum over the
global denominator (all-reduced over dp x fsdp x sp), then the gradients
are summed over those axes: an fsdp-split leaf's over fsdp by the
reduce-scatter of its gathers' backward, every leaf's over the rest by
all-reduce. AdamW is elementwise, so each rank steps its own shards. pp is
train/pipeline.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    _local_logits,
    forward_prefill,
    init_params,
)

DATA_AXES = ("dp", "fsdp", "sp")  # the axes the batch is split over

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


def _nll_sums(
    logits: torch.Tensor,  # [B, S, V] f32: position j predicts targets[:, j]
    targets: torch.Tensor,  # [B, S]
    seq_lens: torch.Tensor,  # [B] whole-row lengths
    offset: int = 0,  # the global index of position 0
    loss_start: torch.Tensor | None = None,  # [B]
    weights: torch.Tensor | None = None,  # [B, S] the weight of predicting targets[:, j]
    tp_group=None,  # `logits` is this rank's vocab block of a tp group's
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum(nll * mask), sum(mask)) of causal_lm_loss over a block of
    target positions starting at global index `offset`."""
    S = targets.shape[1]
    pos = offset + torch.arange(S, device=logits.device)[None, :]
    mask = pos < (seq_lens[:, None] - 1)
    if loss_start is not None:
        mask = mask & (pos >= torch.clamp(loss_start[:, None] - 1, min=0))
    mask = mask.float()
    if weights is not None:
        mask = mask * weights
    if tp_group is None:
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, targets.long(), tp_group)
    return (nll * mask).sum(), mask.sum()


def _vocab_parallel_nll(local: torch.Tensor, targets: torch.Tensor, group) -> torch.Tensor:
    """-log softmax(logits)[target] [B, S] from this rank's vocab block of
    the logits [B, S, V/tp], as GSPMD reduces a log-softmax over a split
    axis: each rank's log-sum-exp joined (a [B, S, tp] gather) and the
    target's logit summed from the rank that holds it, so the [B, S, V]
    logits are never gathered. Every rank gets the same values; each
    backpropagates into its own block."""
    from k8s_llm_scheduler_tpu_torch.parallel.collectives import gather_vocab, reduce_from_tp

    block = local.shape[-1]
    m = local.detach().amax(dim=-1)
    part = m + torch.log(torch.exp(local - m[..., None]).sum(dim=-1))
    lse = torch.logsumexp(gather_vocab(part[..., None], group), dim=-1)
    idx = targets - group.rank * block
    hit = (idx >= 0) & (idx < block)
    picked = local.gather(-1, idx.clamp(0, block - 1)[..., None])[..., 0]
    return lse - reduce_from_tp(torch.where(hit, picked, 0.0), group)


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
    num, den = _nll_sums(logits[:, :-1], tokens[:, 1:], seq_lens, 0, loss_start,
                         None if loss_weights is None else loss_weights[:, 1:])
    return num / torch.clamp(den, min=1.0)


def make_train_step(
    cfg: LlamaConfig,
    device: str | torch.device = "cuda",
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    lr_schedule: Callable[[int], float] | None = None,
    *,
    mesh=None,
    use_ring_attention: bool | None = None,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) on `device`, on one device or over `mesh` (a
    parallel/mesh.RankMesh bound to this process's rank; on a CUDA device
    each rank runs on its mesh.local_device_index()).

    init_fn(seed_or_params) -> TrainState: the port's init_params from a
    seed, or a whole params tree (models/convert.params_from_jax's, or a
    restored checkpoint's) moved onto the device (a tensor already there is
    trained in place); on a mesh, this rank's slice of it. Every floating
    leaf then requires grad, and `optimizer` (a factory over the leaves;
    default adamw(1e-5)) holds the moments, in the params' dtype as optax
    keeps them.

    step_fn(state, tokens, seq_lens, loss_start=None, loss_weights=None)
    -> (state, loss): one update from the loss of a recomputing forward;
    `loss` is a 0-dim f32 tensor on the device (the whole batch's, on every
    rank), read by the caller when it wants it. `lr_schedule(n)`, when
    given, sets the learning rate of the n-th update (n from 0), as an
    optax schedule is evaluated at the update count.
    step_fn.place_batch(tokens, seq_lens, loss_start=None, loss_weights=None)
    takes the WHOLE host batch (numpy; the same on every rank) and returns
    as many tensors on the device as it was given: on a mesh, this rank's
    rows and columns (the JAX step's `local_rows`).
    step_fn.gather_params(params) returns the whole tree (on a mesh, on
    every rank: a collective every rank calls) and step_fn.specs is the
    params' spec tree (parallel/sharding.py).
    `use_ring_attention` defaults to the mesh having an sp axis wider
    than 1, which needs it."""
    dev = resolve_device(device)
    make_optimizer = optimizer or adamw()
    if mesh is not None and mesh.size > 1:
        return _make_mesh_step(cfg, dev, make_optimizer, lr_schedule, mesh,
                               use_ring_attention)
    if use_ring_attention:
        raise ValueError("ring attention needs a mesh with an sp axis wider than 1")

    def init_fn(seed_or_params: int | Params = 0) -> TrainState:
        if isinstance(seed_or_params, dict):
            params = _to_device(seed_or_params, dev)
        else:
            params = init_params(cfg, seed=int(seed_or_params), device=dev)
        return _state(params, make_optimizer)

    def step_fn(state: TrainState, tokens, seq_lens, loss_start=None, loss_weights=None):
        opt = _start_step(state, lr_schedule)
        logits, _, _ = forward_prefill(state.params, cfg, tokens, seq_lens, remat=True)
        loss = causal_lm_loss(logits, tokens, seq_lens, loss_start, loss_weights)
        del logits
        loss.backward()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    def place_batch(tokens, seq_lens, loss_start=None, loss_weights=None):
        return _place(dev, tokens, seq_lens, loss_start, loss_weights)

    from k8s_llm_scheduler_tpu_torch.parallel.sharding import param_specs

    step_fn.place_batch = place_batch  # type: ignore[attr-defined]
    step_fn.gather_params = lambda params: params  # type: ignore[attr-defined]
    step_fn.specs = param_specs(cfg, tp=None)  # type: ignore[attr-defined]
    return init_fn, step_fn


def _state(params: Params, make_optimizer) -> TrainState:
    leaves = [t for t in param_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(params, make_optimizer(leaves), 0)


def _start_step(state: TrainState, lr_schedule) -> torch.optim.Optimizer:
    opt = state.optimizer
    if lr_schedule is not None:
        lr = float(lr_schedule(state.step))
        for group in opt.param_groups:
            group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    return opt


def _place(dev, tokens, seq_lens, loss_start=None, loss_weights=None) -> tuple:
    placed = [torch.as_tensor(tokens).to(dev, torch.long),
              torch.as_tensor(seq_lens).to(dev, torch.int32)]
    if loss_start is not None:
        placed.append(torch.as_tensor(loss_start).to(dev, torch.int32))
    if loss_weights is not None:
        placed.append(torch.as_tensor(loss_weights).to(dev, torch.float32))
    return tuple(placed)


def mesh_device(mesh, device: str | torch.device) -> torch.device:
    """The device of `mesh`'s bound rank: the CPU, or its local CUDA card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = mesh.local_device_index()
    return torch.device("cuda", 0 if index is None else index)


def axes_of(mesh, names) -> tuple[str, ...]:
    """The axes among `names` that `mesh` splits (wider than 1), in the
    mesh's order."""
    return tuple(a for a in mesh.axis_names if a in names and mesh.shape[a] > 1)


def reduce_grads(mesh, params: Params, specs: Params, axes: tuple[str, ...]) -> None:
    """Sum every leaf's gradient over `axes`, except over an axis that
    splits the leaf (an fsdp leaf's gathers' backward summed it there; a
    pp stage's layers are its own): one flat all-reduce for each set of
    axes and dtype, in a fixed leaf order."""
    buckets: dict[tuple, list[torch.Tensor]] = {}
    for leaf, spec in zip(param_leaves(params), _spec_leaves(params, specs)):
        if not leaf.is_floating_point():
            continue
        over = tuple(a for a in axes if a not in spec)
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        if over:
            buckets.setdefault((over, leaf.grad.dtype), []).append(leaf.grad)
    for (over, _dtype), grads in sorted(buckets.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.group(over).all_reduce(flat)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def _spec_leaves(params: Params, specs: Params) -> list[tuple]:
    """The specs of param_leaves(params), in the same order."""
    out = []
    for key in sorted(params):
        node = params[key]
        out.extend(_spec_leaves(node, specs[key]) if isinstance(node, dict) else [specs[key]])
    return out


def _make_mesh_step(cfg, dev, make_optimizer, lr_schedule, mesh, use_ring_attention):
    from k8s_llm_scheduler_tpu_torch.parallel.ring_attention import make_ring_prefill_attention
    from k8s_llm_scheduler_tpu_torch.parallel.sharding import (
        param_specs,
        shard_params,
        unshard_params,
        validate_specs_divisibility,
    )
    from k8s_llm_scheduler_tpu_torch.train.plane import TrainingPlane

    shape = mesh.shape
    if shape.get("pp", 1) > 1:
        raise ValueError("a pp axis trains through train/pipeline.make_pp_train_step")
    sp = shape.get("sp", 1)
    if use_ring_attention is None:
        use_ring_attention = sp > 1
    if sp > 1 and not use_ring_attention:
        raise ValueError("an sp axis wider than 1 splits attention: it needs ring attention")
    if use_ring_attention and sp == 1:
        raise ValueError("ring attention needs a mesh with an sp axis wider than 1")
    validate_specs_divisibility(cfg, mesh)
    tp = shape.get("tp", 1)
    dev = mesh_device(mesh, dev)
    specs = param_specs(cfg, tp="tp" if shape.get("tp", 1) > 1 else None,
                        fsdp="fsdp" if shape.get("fsdp", 1) > 1 else None)
    plane = TrainingPlane(mesh, specs)
    rcfg = plane.local_config(cfg)
    attn_impl = make_ring_prefill_attention(mesh, "sp") if use_ring_attention else None
    data_axes = axes_of(mesh, DATA_AXES)
    row_axes = axes_of(mesh, ("dp", "fsdp"))
    n_rows = 1
    row = 0
    for a in row_axes:
        row = row * shape[a] + mesh.axis_index(a)
        n_rows *= shape[a]
    sp_index = mesh.axis_index("sp")

    def init_fn(seed_or_params: int | Params = 0) -> TrainState:
        if isinstance(seed_or_params, dict):  # sliced where it lies, then moved
            local = _to_device(shard_params(seed_or_params, mesh, specs=specs), dev)
        else:
            full = init_params(cfg, seed=int(seed_or_params), device=dev)
            local = shard_params(full, mesh, specs=specs)
            del full
        return _state(local, make_optimizer)

    def step_fn(state: TrainState, tokens, seq_lens, loss_start=None, loss_weights=None):
        opt = _start_step(state, lr_schedule)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        offset = sp_index * inputs.shape[1]
        *_, hidden = forward_prefill(state.params, rcfg, inputs, seq_lens, remat=True,
                                     return_logits=False, return_hidden=True,
                                     attn_impl=attn_impl, position_offset=offset)
        logits = _local_logits(state.params, rcfg, hidden)
        del hidden
        num, den = _nll_sums(logits, targets, seq_lens, offset, loss_start,
                             None if loss_weights is None else loss_weights[:, 1:],
                             tp_group=mesh.group("tp") if tp > 1 else None)
        del logits
        if data_axes:
            den = mesh.group(data_axes).all_reduce(den.detach().clone())
        loss = num / torch.clamp(den, min=1.0)
        loss.backward()
        reduce_grads(mesh, state.params, specs, data_axes)
        opt.step()
        loss = loss.detach().clone()
        if data_axes:
            loss = mesh.group(data_axes).all_reduce(loss)
        return TrainState(state.params, opt, state.step + 1), loss

    def place_batch(tokens, seq_lens, loss_start=None, loss_weights=None):
        """This rank's rows (split over dp x fsdp) and columns (over sp),
        the columns one wider: the next chunk's first token, the target of
        the chunk's last position (0 past the sequence's end)."""
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        if B % n_rows or S % sp:
            raise ValueError(f"batch [{B}, {S}] does not split over rows {n_rows} x sp {sp}")
        rows = slice(row * (B // n_rows), (row + 1) * (B // n_rows))
        lo = sp_index * (S // sp)
        cols = slice(lo, lo + S // sp + 1)

        def block(a):
            a = np.asarray(a)[rows]
            return np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)[:, cols]

        return _place(dev, block(tokens), np.asarray(seq_lens)[rows],
                      None if loss_start is None else np.asarray(loss_start)[rows],
                      None if loss_weights is None else block(loss_weights))

    step_fn.place_batch = place_batch  # type: ignore[attr-defined]
    step_fn.gather_params = lambda params: unshard_params(params, mesh, specs)  # type: ignore[attr-defined]
    step_fn.specs = specs  # type: ignore[attr-defined]
    return init_fn, step_fn


def _to_device(tree: Params, dev: torch.device) -> Params:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)
