"""AdamW, global-norm clipping and the warmup-cosine schedule (port of
``repro/training/optimizer.py``), on flat lists of tensors.

The float operations are the reference's, in its order: the update runs on
each rank's LOCAL shards, elementwise, in fp32, and a bf16 parameter is
updated through fp32 and cast back.  The global gradient norm is the
caller's (``global_norm_sq``: already summed over the ranks), so the clip
threshold is the same on every rank."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass
class AdamWState:
    step: int
    mu: List[torch.Tensor]            # fp32, one per parameter
    nu: List[torch.Tensor]


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 scalar tensor: linear warmup
    over ``warmup`` steps, then cosine to ``min_frac`` at ``total``."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)


def global_norm_sq_local(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squares of every gradient, fp32, in order."""
    total = torch.zeros((), dtype=torch.float32,
                        device=grads[0].device if grads else None)
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return total


def clip_scale(gnorm: torch.Tensor, grad_clip: float):
    """``min(1, grad_clip / max(gnorm, 1e-12))``, or 1.0 without clipping."""
    if not grad_clip:
        return 1.0
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)


def bias_corrections(step: int, b1: float, b2: float, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - b ** step`` for both moments, as fp32 scalars."""
    s = torch.tensor(step, dtype=torch.float32, device=device)
    return 1 - torch.pow(b1, s), 1 - torch.pow(b2, s)


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamWState, *, lr,
                 weight_decay: float, grad_clip: float,
                 global_norm_sq: Optional[torch.Tensor] = None,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 ndims: Optional[Sequence[int]] = None) -> AdamWState:
    """One AdamW step, IN PLACE, parameter by parameter (so no second copy
    of the moments is ever held): each parameter takes its new value, the
    state its new moments and step; returns the state.
    ``global_norm_sq``: the squared gradient norm already summed over the
    ranks (default: these gradients' own).  Weight decay applies to
    matrices only: parameters whose rank (``ndims``, default each
    parameter's own) is at least 2."""
    if global_norm_sq is None:
        global_norm_sq = global_norm_sq_local(grads)
    scale = clip_scale(torch.sqrt(global_norm_sq), grad_clip)
    state.step += 1
    dev = params[0].device if params else None
    c1, c2 = bias_corrections(state.step, b1, b2, dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    for i, (p, g) in enumerate(zip(params, grads)):
        gf = g.float() * scale
        m2 = b1 * state.mu[i] + (1 - b1) * gf
        v2 = b2 * state.nu[i] + (1 - b2) * torch.square(gf)
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        ndim = p.ndim if ndims is None else ndims[i]
        if weight_decay and ndim >= 2:            # decay matrices only
            delta = delta + weight_decay * p.float()
        with torch.no_grad():
            p.copy_(p.float() - lr * delta)
        state.mu[i], state.nu[i] = m2, v2
    return state
