"""Deferred TP collectives, the mechanism behind ISO (port of
``repro/core/overlap.py``).

The pattern the scheduler (core/iso.py) follows:

    pend = psum_start(partial_c0, ctx)            # issue the collective NOW
    other = attn(chunk1)                          # independent overlap work
    reduced, (other,) = psum_wait(pend, (other,)) # complete it

PyTorch runs eagerly, so the program order is the schedule: XLA's scheduler
may move a collective, the port's never moves.  ``psum_start`` therefore
issues ``dist.all_reduce(async_op=True)`` the moment the partial exists, and
the overlap work enqueued before ``psum_wait`` is what runs beside it.
``psum_wait`` calls ``Work.wait()``, which orders the current stream after
the collective (NCCL) or completes it (gloo), and hands the overlap outputs
back unchanged: the reference's optimization barrier has nothing to pin in
eager code, but callers keep its calling convention.

At tp=1 (``tp_axis=None``) every collective is the identity.

Under autograd (training: a partial that requires grad while grad mode is
on) the reduce is ``all_reduce_sum``, an ``autograd.Function`` run at once,
out of place, whose backward all-reduces the cotangent.  That is the
transpose the reference's ``lax.psum`` gets inside ``shard_map(check_vma=
False)``: every cotangent reaching a reduce is summed over the ranks, so a
tp=M gradient is M x the tp=1 one (ROADMAP queue C).  Serving never builds
an autograd graph and keeps the in-place, asynchronous reduces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quantized_collectives import all_gather_stack, \
    quantized_psum_finish, quantized_psum_start


@dataclass(frozen=True)
class AxisCtx:
    """The TP group (and, in training, the data-parallel group) as seen by
    the stage code.

    ``tp_axis=None`` means single-device execution: all collectives are the
    identity.  Otherwise ``group`` is the ``torch.distributed`` process
    group of the tp ranks (None: the default group) and ``rank`` this
    process's index in it.  ``quantized_comm`` sends every reduce through
    the int8 ``quantized_psum``.  ``dp_axes`` (the reference's batch axes,
    empty: no data parallelism) with ``dp`` ranks in ``dp_group``, where
    this process is ``dp_rank``: the group of the gradient mean."""
    tp_axis: Optional[str] = None
    tp: int = 1
    group: Any = None
    rank: int = 0
    quantized_comm: bool = False
    dp_axes: Tuple[str, ...] = ()
    dp: int = 1
    dp_group: Any = None
    dp_rank: int = 0

    def __post_init__(self):
        if self.tp_axis is None and self.tp != 1:
            raise ValueError(f"AxisCtx: tp={self.tp} needs a tp_axis (and "
                             f"the process group)")
        if not 0 <= self.rank < self.tp:
            raise ValueError(f"AxisCtx: rank {self.rank} outside tp="
                             f"{self.tp}")
        if not self.dp_axes and self.dp != 1:
            raise ValueError(f"AxisCtx: dp={self.dp} needs dp_axes (and "
                             f"the process group)")
        if not 0 <= self.dp_rank < self.dp:
            raise ValueError(f"AxisCtx: dp rank {self.dp_rank} outside dp="
                             f"{self.dp}")

    def axis_index(self) -> int:
        return self.rank


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, out of place; the backward sums the cotangent
    over the group (``lax.psum``'s transpose under ``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def _autograd(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


@dataclass
class Pending:
    """A collective that has been issued but not awaited.  ``work`` is the
    ``dist.Work`` of an all-reduce running in place on ``partial``, or the
    quantized reduce's phase-1 state; None for the identity and for a
    reduce under autograd, whose ``partial`` is then already the sum."""
    partial: torch.Tensor
    ctx: AxisCtx
    work: Any = None

    @property
    def noop(self) -> bool:
        return self.ctx.tp_axis is None or self.work is None


def psum_start(partial: torch.Tensor, ctx: AxisCtx) -> Pending:
    """Issue the reduce of ``partial`` without waiting for it.  The plain
    all-reduce runs in place: the caller must not read ``partial`` until
    ``psum_wait``.  With ``quantized_comm`` the int8 quantize and wire
    phase 1 (all-to-all) are issued here; phase 2 (all-gather) runs inside
    ``psum_wait``, so part of that reduce completes there, exposed.  Under
    autograd the reduce is ``all_reduce_sum``, complete on return."""
    if ctx.tp_axis is None:
        return Pending(partial, ctx)
    if _autograd(partial):
        if ctx.quantized_comm:
            raise NotImplementedError(
                "int8 TP reduces under autograd: the reference's rounding "
                "has no gradient; train with ISOConfig(quantized_comm="
                "False)")
        return Pending(all_reduce_sum(partial, ctx.group), ctx)
    if ctx.quantized_comm:
        return Pending(partial, ctx,
                       quantized_psum_start(partial, ctx.group, ctx.tp))
    return Pending(partial, ctx,
                   dist.all_reduce(partial, group=ctx.group, async_op=True))


def psum_wait(pend: Pending, overlap_outputs: Sequence = ()) -> Tuple:
    """Complete the collective.  Returns (reduced, overlap_outputs); callers
    thread the returned overlap outputs on, as with the reference's
    barrier."""
    if pend.noop:
        return pend.partial, tuple(overlap_outputs)
    if pend.ctx.quantized_comm:
        return quantized_psum_finish(pend.work), tuple(overlap_outputs)
    pend.work.wait()
    return pend.partial, tuple(overlap_outputs)


def psum_now(partial: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """Immediate (baseline, non-overlapped) reduce, in place like
    ``psum_start``."""
    return psum_wait(psum_start(partial, ctx))[0]


def dp_psum(x: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """Sum over the data-parallel ranks (the loss, gradient norms), out of
    place and outside autograd; the identity without data parallelism."""
    if not ctx.dp_axes:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=ctx.dp_group)
    return y


def all_gather_last(x: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """Concatenate every rank's ``x`` (..., n) along the last dim, rank
    order: (..., tp * n).  The vocab-sharded logits become the full row
    (the reference's ``P(..., "model")`` out_spec)."""
    if ctx.tp_axis is None:
        return x
    out = all_gather_stack(x, ctx.group, ctx.tp)       # (tp, ..., n)
    return out.movedim(0, -2).reshape(*x.shape[:-1], ctx.tp * x.shape[-1])
