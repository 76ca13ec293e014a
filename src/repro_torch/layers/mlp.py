"""SwiGLU MLP, local-shard view with an unreduced output (port of
``repro/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_partial(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """(B,S,D) -> unreduced (B,S,D) partial; the caller applies the TP
    all-reduce.  Same rounding as the reference: ``silu(gate)`` is computed in
    fp32 and cast to the activation dtype BEFORE the product with ``up``."""
    if mlp_type != "swiglu":
        raise NotImplementedError(
            f"mlp_type {mlp_type!r}: the port serves swiglu stacks only "
            f"(ROADMAP queue A item 10)")
    up = torch.matmul(x, p["w_up"])
    gate = torch.matmul(x, p["w_gate"])
    h = F.silu(gate.float()).to(x.dtype) * up
    return torch.matmul(h, p["w_down"])
