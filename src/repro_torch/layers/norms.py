"""RMSNorm / LayerNorm with fp32 accumulation (port of
``repro/layers/norms.py``).

Keeps the reference's rounding: ``reciprocal(sqrt(.))``, not ``rsqrt``, and
the population variance in LayerNorm (``jnp.var``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(params: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """``kind`` "ln": LayerNorm, else RMSNorm; ``eps`` is the config's
    ``rms_eps`` for both, as the reference passes it."""
    if kind == "ln":
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)


def init_norm(d: int, device=None, kind: str = "rms") -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p
