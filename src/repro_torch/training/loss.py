"""Vocab-sharded cross-entropy (Megatron-style), local-shard view (port of
``repro/training/loss.py``)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.overlap import AxisCtx, all_reduce_sum


def sharded_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                 ctx: AxisCtx, *, mask: torch.Tensor = None) -> torch.Tensor:
    """logits_local: (B, S, V_loc), this rank's vocab slice; labels: (B, S)
    global ids.  Returns the mean NLL over unmasked tokens (the same on
    every model rank), in fp32.

    The max shift is taken on a detached local max and its all-reduce
    (``MAX``) stays outside autograd, as the reference stops the gradient
    before its ``pmax``; the sums of the exponentials and of the picked
    logit are differentiable all-reduces (``all_reduce_sum``)."""
    lf = logits_local.float()
    v_loc = lf.shape[-1]
    offset = ctx.axis_index() * v_loc
    gmax = torch.amax(lf.detach(), dim=-1)
    if ctx.tp_axis is not None:
        gmax = gmax.contiguous()
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=ctx.group)
    se = torch.sum(torch.exp(lf - gmax[..., None]), dim=-1)
    gse = all_reduce_sum(se, ctx.group) if ctx.tp_axis is not None else se
    log_z = gmax + torch.log(gse)

    local_idx = labels.long() - offset
    ok = (local_idx >= 0) & (local_idx < v_loc)
    cl = torch.gather(lf, -1, torch.clamp(local_idx, 0, v_loc - 1)[..., None]
                      )[..., 0]
    cl = torch.where(ok, cl, torch.zeros_like(cl))
    gcl = all_reduce_sum(cl, ctx.group) if ctx.tp_axis is not None else cl

    nll = log_z - gcl
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
