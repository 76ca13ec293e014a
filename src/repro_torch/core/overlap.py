"""Deferred TP collectives, the mechanism behind ISO (port of
``repro/core/overlap.py``).

The pattern the scheduler (core/iso.py) follows:

    pend = psum_start(partial_c0, ctx)            # issue the collective
    other = attn(chunk1)                          # independent overlap work
    reduced, (other,) = psum_wait(pend, (other,)) # complete it

At tp=1 every collective is the identity and ``psum_wait`` returns its
inputs unchanged, so the ISO unit order costs nothing and changes no number.
Tensor parallelism (``dist.all_reduce(async_op=True)`` + ``Work.wait()``)
is ROADMAP queue A item 7; ``tp > 1`` raises until it lands.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

_TP_TODO = ("tensor parallelism (tp > 1) is not ported yet: ROADMAP queue A "
            "item 7")


@dataclass(frozen=True)
class AxisCtx:
    """The TP group as seen by the stage code.  ``tp_axis=None`` (tp=1) means
    single-device execution: all collectives are the identity."""
    tp_axis: Optional[str] = None
    tp: int = 1

    def __post_init__(self):
        if self.tp != 1 or self.tp_axis is not None:
            raise NotImplementedError(_TP_TODO)

    def axis_index(self) -> int:
        return 0


@dataclass
class Pending:
    """A collective that has been issued but not awaited."""
    partial: torch.Tensor
    ctx: AxisCtx

    @property
    def noop(self) -> bool:
        return self.ctx.tp_axis is None


def psum_start(partial: torch.Tensor, ctx: AxisCtx) -> Pending:
    return Pending(partial, ctx)


def psum_wait(pend: Pending, overlap_outputs: Sequence = ()) -> Tuple:
    """Complete the collective.  Returns (reduced, overlap_outputs); callers
    thread the returned overlap outputs on, as with the reference's barrier.
    """
    if not pend.noop:
        raise NotImplementedError(_TP_TODO)
    return pend.partial, tuple(overlap_outputs)


def psum_now(partial: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """Immediate (baseline, non-overlapped) reduce."""
    if ctx.tp_axis is not None:
        raise NotImplementedError(_TP_TODO)
    return partial
