"""Fused RMSNorm: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``_rmsnorm_kernel`` of ``repro/kernels/rmsnorm.py``,
which the reference reaches only through ``kernels/ops.rms_norm`` (the
model's norm, ``layers/norms.py``, is plain tensor code in both packages).
The kernel is in ``csrc/rmsnorm.cu``.

For x (..., D), float32 or bfloat16, and gamma (D,), float32 or bfloat16,
per row of the last dim, in fp32:

    out = x * rsqrt(mean(x^2) + eps) * gamma     cast to x.dtype

Bound by bytes: each element is read once and written once.  A warp owns a
short row and a block of 256 threads a long one; the row is read with
16-byte loads for the sum of squares and read again, from L1/L2, to write
the output.  A row that does not allow 16-byte loads takes a scalar path.

``rms_norm_plain`` follows ``repro/kernels/ref.rms_norm_ref``; the wrapper
uses it only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

_SOURCE = "rmsnorm.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """Plain version of the kernel."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6
             ) -> torch.Tensor:
    """x (..., D) float32/bfloat16, gamma (D,) -> x's shape and dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise TypeError(f"rms_norm takes float32 or bfloat16, got x "
                        f"{x.dtype}, gamma {gamma.dtype}")
    if gamma.device != x.device:
        raise ValueError(f"rms_norm: gamma on {gamma.device}, x on "
                         f"{x.device}")
    if x.ndim == 0 or x.shape[-1] == 0 or gamma.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: x {tuple(x.shape)} and gamma "
                         f"{tuple(gamma.shape)} do not agree")
    if x.device.type == "cpu":
        return rms_norm_plain(x, gamma, eps)
    d = x.shape[-1]
    x2 = x.contiguous().reshape(-1, d)
    g = gamma.contiguous()
    rows = x2.shape[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    vec, block_per_row = native.row_launch(x2, out)
    err = native.library(_SOURCE).rms_norm(
        native.dtype_code(x2), native.dtype_code(g), x2.data_ptr(),
        g.data_ptr(), out.data_ptr(), rows, d, float(eps), int(vec),
        int(block_per_row), native.stream_of(x2))
    native.check_launch("rms_norm", err)
    native.LAUNCHES["rms_norm"] += 1
    return out
