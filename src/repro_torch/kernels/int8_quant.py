"""Per-row symmetric int8 quantization: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``_quant_kernel`` of ``repro/kernels/int8_quant.py``,
the quantize step of the int8 all-reduce (``core/quantized_collectives.py``
quantizes twice per reduce).  The kernel is in ``csrc/int8_quant.cu``.

For x (..., D), float32 or bfloat16, per row of the last dim:

    scale = max(max_j |x_j|, 1e-8) * fl32(1/127)  fp32, shape (..., 1)
    q     = clamp(round(x / scale), -127, 127)    int8, shape (..., D)

with the amax taken in fp32 and ``round`` half to even (``torch.round`` here,
``rintf`` on the card).  The reference writes the scale as ``amax / 127``,
but XLA compiles a division by a constant as a multiplication by its fp32
reciprocal, which differs in the last bit for some rows; the port computes
what the compiled Pallas kernel computes, so its q and scale equal that
kernel's bit for bit.  The kernel divides with IEEE ``x / scale`` (built
without fast-math), so on the card its ``q`` and scale are bit-equal to the
plain version's.  Bound by bytes: each element is read once and 1 B per
element plus 4 B per row are written.  A warp owns a short row and a block
of 256 threads a long one; the row is read with 16-byte loads for the
abs-max and read again, from L1/L2, to write q.

``quantize_int8_plain`` follows ``repro/kernels/ref.quantize_int8_ref``; the
wrapper uses it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

_SOURCE = "int8_quant.cu"
# the fp32 reciprocal of 127, held exactly in a Python float
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)


def quantize_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (int8 (..., D), fp32 scale (..., 1))."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) float32/bfloat16 -> (int8 (..., D), fp32 scale (..., 1)).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(f"quantize_int8: no row to quantize in shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    d = x.shape[-1]
    x2 = x.contiguous().reshape(-1, d)
    rows = x2.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    if rows == 0:
        return q, scale
    vec, block_per_row = native.row_launch(x2, q)
    err = native.library(_SOURCE).quantize_int8(
        native.dtype_code(x2), x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        rows, d, int(vec), int(block_per_row), native.stream_of(x2))
    native.check_launch("quantize_int8", err)
    native.LAUNCHES["quantize_int8"] += 1
    return q, scale
