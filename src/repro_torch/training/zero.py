"""ZeRO-1: the AdamW state sharded over the data-parallel ranks (port of
``repro/training/zero.py``).

Each reference leaf (the period-stacked one: a layer leaf's P per-layer
tensors, flattened and concatenated in period order) is handled in its
FLATTENED local view, padded to a multiple of dp; the state keeps one
(N_pad / dp,) fp32 slice of ``mu`` and ``nu`` per leaf on each data rank,
the reference's own layout:

    grad  --reduce_scatter(data) / dp-->  my slice of the mean
    AdamW on the slice (elementwise)
    param --all_gather(data)-->           the new parameter everywhere

The wire carries what the plain all-reduce would, and the optimizer state
divides by dp.  The gradient norm is summed over the slices (they
partition the gradient), over the data ranks and, for a sharded leaf, the
model ranks, as the reference does."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.overlap import AxisCtx
from repro_torch.training.optimizer import bias_corrections, clip_scale

# ``reduce_scatter_tensor``/``all_gather_into_tensor``, which newer torch
# renames ``*_single``
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclass
class Zero1State:
    step: int
    mu: List[torch.Tensor]            # per leaf, (N_pad / dp,) fp32
    nu: List[torch.Tensor]


def _pad_len(n: int, dp: int) -> int:
    return int(math.ceil(n / dp) * dp)


def zero1_init_local(leaves, dp: int) -> Zero1State:
    """Zero moments for this data rank's slices of ``leaves``
    (``trainer.Leaf``)."""
    def z(leaf):
        return torch.zeros((_pad_len(leaf.numel, dp) // dp,),
                           dtype=torch.float32, device=leaf.tensors[0].device)
    return Zero1State(step=0, mu=[z(l) for l in leaves],
                      nu=[z(l) for l in leaves])


def _flat(ts: Sequence[torch.Tensor], n_pad: int) -> torch.Tensor:
    """fp32 concatenation of ``ts`` flattened, zero-padded to ``n_pad``."""
    f = torch.cat([t.float().reshape(-1) for t in ts])
    return torch.nn.functional.pad(f, (0, n_pad - f.shape[0]))


def zero1_update_local(leaves, grads: Sequence[Sequence[torch.Tensor]],
                       state: Zero1State, ctx: AxisCtx, *, lr,
                       weight_decay: float, grad_clip: float,
                       b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8
                       ) -> torch.Tensor:
    """One ZeRO-1 AdamW step on this rank's shards, IN PLACE: each leaf's
    tensors take their new values and the state its new slices and step.
    ``grads[i]``: leaf i's gradients (one per tensor), already summed over
    the model ranks for a replicated leaf but not reduced over data: the
    reduce-scatter here does that, into this rank's slice.  Returns the
    gradient norm."""
    dp = ctx.dp
    # pass 1: reduce-scatter every leaf into my slice; accumulate the norms
    slices, nsq_sharded, nsq_repl = [], 0.0, 0.0
    for leaf, g in zip(leaves, grads):
        n_pad = _pad_len(leaf.numel, dp)
        gf = _flat(g, n_pad)
        if dp > 1:
            part = torch.empty(n_pad // dp, dtype=torch.float32,
                               device=gf.device)
            _reduce_scatter(part, gf, group=ctx.dp_group)
            gf = part
        g_slice = gf / dp
        slices.append(g_slice)
        s = torch.sum(torch.square(g_slice))
        if ctx.tp_axis is not None and leaf.sharded:
            nsq_sharded = nsq_sharded + s
        else:
            nsq_repl = nsq_repl + s
    nsq = _sum_over(nsq_sharded, slices, ctx, model=True) + \
        _sum_over(nsq_repl, slices, ctx, model=False)
    gnorm = torch.sqrt(nsq)
    scale = clip_scale(gnorm, grad_clip)

    state.step += 1
    dev = slices[0].device
    c1, c2 = bias_corrections(state.step, b1, b2, dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    # pass 2: AdamW on the slice, all-gather the new parameters
    for i, (leaf, g_slice) in enumerate(zip(leaves, slices)):
        n, n_pad = leaf.numel, _pad_len(leaf.numel, dp)
        g_slice = g_slice * scale
        m2 = b1 * state.mu[i] + (1 - b1) * g_slice
        v2 = b2 * state.nu[i] + (1 - b2) * torch.square(g_slice)
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        per = n_pad // dp
        p_slice = _flat(leaf.tensors, n_pad)[ctx.dp_rank * per:
                                             (ctx.dp_rank + 1) * per]
        if weight_decay and leaf.ndim >= 2:
            delta = delta + weight_decay * p_slice
        p_new = p_slice - lr * delta
        if dp > 1:
            full = torch.empty(n_pad, dtype=torch.float32, device=dev)
            _all_gather(full, p_new.contiguous(), group=ctx.dp_group)
        else:
            full = p_new
        leaf.assign(full[:n])
        state.mu[i], state.nu[i] = m2, v2
    return gnorm


def _sum_over(x, slices, ctx: AxisCtx, model: bool) -> torch.Tensor:
    """``x`` summed over the data ranks and, with ``model``, the model
    ranks (the reference's psum over (model, data) or data)."""
    if not torch.is_tensor(x):
        x = torch.zeros((), dtype=torch.float32, device=slices[0].device)
    x = x.clone()
    if model:
        if ctx.tp_axis is None:
            return torch.zeros_like(x)
        dist.all_reduce(x, group=ctx.group)
    if ctx.dp > 1:
        dist.all_reduce(x, group=ctx.dp_group)
    return x
