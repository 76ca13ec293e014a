"""Fused SwiGLU activation: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``_swiglu_kernel`` of ``repro/kernels/swiglu.py``,
which the reference reaches only through ``kernels/ops.swiglu``.  The kernel
is in ``csrc/swiglu.cu``.

For gate and up (..., F) of one type, float32 or bfloat16:

    out = silu(gate) * up      in fp32, cast to gate.dtype

The product is taken in fp32, as the TPU kernel does.  The model's MLP
(``layers/mlp.py``, in both packages) rounds ``silu(gate)`` to the
activation type before multiplying, so the two differ in bf16, and the MLP
does not call this kernel.  Bound by bytes: two inputs read once and one
output written once; one grid-stride pass with 16-byte loads and stores,
and a scalar path for base addresses that do not allow them.

``swiglu_plain`` follows ``repro/kernels/ref.swiglu_ref``; the wrapper uses
it only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

_SOURCE = "swiglu.cu"


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel."""
    gf = gate.float()
    return (gf * torch.sigmoid(gf) * up.float()).to(gate.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """gate, up (..., F) float32/bfloat16 -> silu(gate) * up, gate's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if gate.dtype not in (torch.float32, torch.bfloat16) \
            or up.dtype != gate.dtype:
        raise TypeError(f"swiglu takes gate and up of one type, float32 or "
                        f"bfloat16, got {gate.dtype} and {up.dtype}")
    if up.device != gate.device:
        raise ValueError(f"swiglu: up on {up.device}, gate on {gate.device}")
    if up.shape != gate.shape:
        raise ValueError(f"swiglu: gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    if gate.device.type == "cpu":
        return swiglu_plain(gate, up)
    g = gate.contiguous()
    u = up.contiguous()
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    n = g.numel()
    if n == 0:
        return out
    vec = all(t.data_ptr() % 16 == 0 for t in (g, u, out))
    err = native.library(_SOURCE).swiglu(
        native.dtype_code(g), g.data_ptr(), u.data_ptr(), out.data_ptr(), n,
        int(vec), native.stream_of(g))
    native.check_launch("swiglu", err)
    native.LAUNCHES["swiglu"] += 1
    return out
