"""Column -> row parallel MLP (SwiGLU or GELU), local-shard view with an
unreduced output (port of ``repro/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum`` types
    a mixed product: float32 activations against bfloat16 weights (the
    whisper encoder on float32 frames) compute in float32."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


def mlp_partial(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """(B,S,D) -> unreduced (B,S,D) partial; the caller applies the TP
    all-reduce.  Same rounding as the reference: the activation (``silu``
    of the gate, or the tanh-approximate GELU that ``jax.nn.gelu`` defaults
    to) is computed in fp32 and cast to the activation dtype before the
    product with ``up`` / ``w_down``."""
    up = matmul(x, p["w_up"])
    if mlp_type == "swiglu":
        gate = matmul(x, p["w_gate"])
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return matmul(h, p["w_down"])
