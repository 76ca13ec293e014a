"""Rotary position embeddings with explicit positions (port of
``repro/layers/rope.py``): chunked prefill needs each chunk's absolute
start."""
from __future__ import annotations

import math

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


def sinusoid_angles(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoids at fp32 ``positions`` (any shape):
    ``[sin | cos]`` over the last dim (not interleaved), the inverse
    frequency dividing by ``half - 1`` (not ``half``), as the reference
    builds its table.  (..., ) -> (..., d_model) float32."""
    half = d_model // 2
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(seq_len: int, d_model: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """The sinusoid table's rows [offset, offset + seq_len): (seq_len,
    d_model) float32."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    return sinusoid_angles(pos, d_model)
