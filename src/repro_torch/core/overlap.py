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
    """The TP group as seen by the stage code.

    ``tp_axis=None`` means single-device execution: all collectives are the
    identity.  Otherwise ``group`` is the ``torch.distributed`` process
    group of the tp ranks (None: the default group) and ``rank`` this
    process's index in it.  ``quantized_comm`` sends every reduce through
    the int8 ``quantized_psum``."""
    tp_axis: Optional[str] = None
    tp: int = 1
    group: Any = None
    rank: int = 0
    quantized_comm: bool = False

    def __post_init__(self):
        if self.tp_axis is None and self.tp != 1:
            raise ValueError(f"AxisCtx: tp={self.tp} needs a tp_axis (and "
                             f"the process group)")
        if not 0 <= self.rank < self.tp:
            raise ValueError(f"AxisCtx: rank {self.rank} outside tp="
                             f"{self.tp}")

    def axis_index(self) -> int:
        return self.rank


@dataclass
class Pending:
    """A collective that has been issued but not awaited.  ``work`` is the
    ``dist.Work`` of an all-reduce running in place on ``partial``, or the
    quantized reduce's phase-1 state; None for the identity."""
    partial: torch.Tensor
    ctx: AxisCtx
    work: Any = None

    @property
    def noop(self) -> bool:
        return self.ctx.tp_axis is None


def psum_start(partial: torch.Tensor, ctx: AxisCtx) -> Pending:
    """Issue the reduce of ``partial`` without waiting for it.  The plain
    all-reduce runs in place: the caller must not read ``partial`` until
    ``psum_wait``.  With ``quantized_comm`` the int8 quantize and wire
    phase 1 (all-to-all) are issued here; phase 2 (all-gather) runs inside
    ``psum_wait``, so part of that reduce completes there, exposed."""
    if ctx.tp_axis is None:
        return Pending(partial, ctx)
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


def all_gather_last(x: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """Concatenate every rank's ``x`` (..., n) along the last dim, rank
    order: (..., tp * n).  The vocab-sharded logits become the full row
    (the reference's ``P(..., "model")`` out_spec)."""
    if ctx.tp_axis is None:
        return x
    out = all_gather_stack(x, ctx.group, ctx.tp)       # (tp, ..., n)
    return out.movedim(0, -2).reshape(*x.shape[:-1], ctx.tp * x.shape[-1])
