"""Rotary position embeddings with explicit positions (port of
``repro/layers/rope.py``): chunked prefill needs each chunk's absolute
start."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(theta), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S) absolute token positions."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)          # (D/2,)
    ang = positions.float()[..., None] * inv              # (..., S, D/2)
    if ang.ndim == 2:                                     # (S, D/2) -> (1, S, D/2)
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]                   # (B, S, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
