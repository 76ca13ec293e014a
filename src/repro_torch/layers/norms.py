"""RMSNorm with fp32 accumulation (port of ``repro/layers/norms.py``).

Keeps the reference's rounding: ``reciprocal(sqrt(.))``, not ``rsqrt``."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(x.dtype)


def norm(params: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    if kind != "rms":
        raise NotImplementedError(
            f"norm_type {kind!r}: the port serves rms-normed dense stacks "
            f"only (ROADMAP queue A item 10)")
    return rms_norm(x, params["scale"], eps)


def init_norm(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
