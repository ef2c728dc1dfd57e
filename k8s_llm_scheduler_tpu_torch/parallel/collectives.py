"""Differentiable collectives over an `AxisGroup` (parallel/launch.py).

The JAX package differentiates through its collectives: XLA transposes a
`ppermute` into the reverse permute and an all-gather of fsdp weights into
a reduce-scatter of their gradients. Here each rank is a process, so every
collective of a training forward is a torch.autograd.Function whose
backward issues the transposed collective on the same group. Every rank
runs the same program, so each runs its backward's collectives in the same
order. None of them works in place on a tensor autograd may have saved.

- `ppermute(x, group, shift)`: send to rank + shift, receive from
  rank - shift; backward the permute by -shift.
- `all_gather(x, group, dim)`: the ranks' blocks joined along `dim`;
  backward the reduce-scatter of the gradient (the gathered weight's
  gradients of every rank summed, each rank keeping its block).
- Megatron's conjugate pair for tensor parallelism: `copy_to_tp`
  (identity forward, all-reduce backward) before a column-parallel
  product, whose input's gradient is a partial sum on each rank, and
  `reduce_from_tp` (all-reduce forward, identity backward) after a
  row-parallel one. torch.distributed.nn.functional.all_reduce is not
  reduce_from_tp: its backward all-reduces again, which on a loss every tp
  rank computes alike gives tp times the gradient.
- `gather_vocab(local, group)`: a rank's vocab block of the logits into
  the whole vocab on every rank (an all-reduce of a zero-filled buffer);
  backward the rank's block of the gradient.
"""

from __future__ import annotations

import torch


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return group.permute(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.permute(grad, -ctx.shift), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        block = local.shape[-1]
        lo = group.rank * block
        ctx.lo, ctx.block = lo, block
        full = torch.zeros((*local.shape[:-1], block * group.size), dtype=local.dtype,
                           device=local.device)
        full[..., lo:lo + block] = local
        return group.all_reduce(full)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.lo + ctx.block], None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    return _Ppermute.apply(x, group, shift)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _AllGather.apply(x, group, dim)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_vocab(local: torch.Tensor, group) -> torch.Tensor:
    return _GatherVocab.apply(local, group)
