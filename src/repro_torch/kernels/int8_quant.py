"""Per-row symmetric int8 quantization and the local steps of the int8
all-reduce: CUDA kernels, plain versions, wrappers.

``quantize_int8`` replaces the TPU kernel ``_quant_kernel`` of
``repro/kernels/int8_quant.py`` (B7).  The other three are the whole local
part of the int8 all-reduce (``core/quantized_collectives.py``), one launch
each around the two collectives, sharing B7's row code:

    quantize_int8_shards(x, tp)        x (..., D) -> q (tp, ..., D/tp) int8,
                                       scale (tp, ..., 1): B7 on each shard,
                                       written shard first (the layout
                                       ``all_to_all_single`` exchanges)
    dequant_sum_quantize_int8(q, s)    (tp, ..., d) int8, (tp, ..., 1) ->
                                       B7 of sum_t q_t * s_t (fp32, rank
                                       order): (..., d) int8, (..., 1)
    dequantize_int8_gathered(q, s, dt) (tp, ..., d) int8, (tp, ..., 1) ->
                                       (..., tp * d) of dtype dt

The kernels are in ``csrc/int8_quant.cu``.  For x (..., D), float32 or
bfloat16, per row of the last dim, B7 computes

    scale = max(max_j |x_j|, 1e-8) * fl32(1/127)  fp32, shape (..., 1)
    q     = clamp(round(x / scale), -127, 127)    int8, shape (..., D)

with the amax taken in fp32 and ``round`` half to even (``torch.round`` here,
``rintf`` on the card).  The reference writes the scale as ``amax / 127``,
but XLA compiles a division by a constant as a multiplication by its fp32
reciprocal, which differs in the last bit for some rows; the port computes
what the compiled Pallas kernel computes, so its q and scale equal that
kernel's bit for bit.  The kernels divide with IEEE ``x / scale`` (built
without fast-math) and round each dequantize product and rank sum to
nearest, one operation at a time, as the plain versions do (the rank sum is
an explicit loop in rank order), so on the card q, the scales and the
dequantized values are bit-equal to the plain versions'.  Bound by bytes:
each element is read once and written once.  The three quantize kernels
take a launch plan (``native.row_plan``): a warp owns a short row and a
block of 256 threads a longer one, which it reads with vector loads for the
abs-max and again, from L1/L2, to write q; a row too long for its rows'
blocks to fill the card (the gradient mean's ``dp`` rows of a flattened
leaf) is split over many blocks, in two launches: the segments' abs-maxes
into a scratch buffer, then each segment's q.  Such a call counts once in
``native.LAUNCHES`` under its name and once under ``<name>/split`` in
``native.VARIANTS``.  The max does not depend on order, so the bits are the
same on every path.

The plain versions follow ``repro/kernels/ref.quantize_int8_ref`` and
``repro/core/quantized_collectives.quantized_psum``; the wrappers use them
only for CPU tensors, and the int8 reduce's three also for ``meta`` tensors
(the dry run's trace, shapes without data).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import native

_SOURCE = "int8_quant.cu"
# the fp32 reciprocal of 127, held exactly in a Python float
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)
# devices whose tensors the int8 reduce's wrappers hand to the plain
# versions
_PLAIN_DEVICES = ("cpu", "meta")


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


def _launch_check(name: str, err: int, plan=None) -> None:
    native.check_launch(name, err)
    native.LAUNCHES[name] += 1
    if plan is not None and plan.mode == "split":
        native.VARIANTS[f"{name}/split"] += 1


def _plan(name: str, rows: int, d: int, x: torch.Tensor, out: torch.Tensor,
          vec_bytes: int = 16):
    """The launch plan of a quantize kernel over ``rows`` rows of ``d`` of
    x into out, with its C arguments: (plan, partial scratch (rows,
    segments) fp32 under a split, else None, (partial pointer, vec, mode,
    segments, seg_len))."""
    plan = native.row_plan(rows, d, x.element_size(),
                           x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                           vec_bytes, kernel=name)
    partial = torch.empty((rows, plan.segments), dtype=torch.float32,
                          device=x.device) if plan.mode == "split" else None
    args = (0 if partial is None else partial.data_ptr(), int(plan.vec),
            native.ROW_MODES.index(plan.mode), plan.segments, plan.seg_len)
    return plan, partial, args


def _check_float(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) float32/bfloat16 -> (int8 (..., D), fp32 scale (..., 1)).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_float("quantize_int8", x)
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
    plan, partial, (p, *launch) = _plan("quantize_int8", rows, d, x2, q)
    _launch_check("quantize_int8", native.library(_SOURCE).quantize_int8(
        native.dtype_code(x2), x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        p, rows, d, *launch, native.stream_of(x2)), plan)
    return q, scale


def _check_exchange(name: str, q: torch.Tensor, s: torch.Tensor) -> None:
    """q (tp, ..., d) int8 and s (tp, ..., 1) fp32 on one device."""
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name}: q must be int8 and the scales float32, got "
                        f"{q.dtype} and {s.dtype}")
    if q.ndim < 2 or s.shape != (*q.shape[:-1], 1) or q.shape[-1] == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} are not (tp, ..., d) and "
                         f"(tp, ..., 1)")
    if s.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, scales on {s.device}")


def quantize_int8_shards_plain(x: torch.Tensor, tp: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: B7 on the tp shards of each row, shard first."""
    q, scale = quantize_int8_plain(
        x.reshape(*x.shape[:-1], tp, x.shape[-1] // tp))
    return q.movedim(-2, 0).contiguous(), scale.movedim(-2, 0).contiguous()


def quantize_int8_shards(x: torch.Tensor, tp: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D), D % tp == 0 -> q (tp, ..., D/tp) int8 and scale
    (tp, ..., 1) fp32: shard t of each row quantized as a row of its own.
    CPU (and meta) tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_float("quantize_int8_shards", x)
    if x.ndim == 0 or tp < 1 or x.shape[-1] == 0 or x.shape[-1] % tp:
        raise ValueError(f"quantize_int8_shards: last dim of "
                         f"{tuple(x.shape)} not a positive multiple of "
                         f"tp={tp}")
    if x.device.type in _PLAIN_DEVICES:
        return quantize_int8_shards_plain(x, tp)
    d = x.shape[-1] // tp
    x2 = x.contiguous().reshape(-1, d)                  # (R * tp, d)
    R = x2.shape[0] // tp
    q = torch.empty((tp, *x.shape[:-1], d), dtype=torch.int8,
                    device=x.device)
    scale = torch.empty((tp, *x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    if R == 0:
        return q, scale
    plan, partial, (p, *launch) = _plan("quantize_int8_shards", R * tp, d,
                                        x2, q)
    _launch_check("quantize_int8_shards", native.library(
        _SOURCE).quantize_int8_shards(
        native.dtype_code(x2), x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        p, R, d, tp, *launch, native.stream_of(x2)), plan)
    return q, scale


def dequant_sum_quantize_int8_plain(q: torch.Tensor, scale: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: sum_t q_t * s_t in fp32, rank by rank in order, then
    B7 of the sum."""
    part = q[0].float() * scale[0]
    for t in range(1, q.shape[0]):
        part = part + q[t].float() * scale[t]
    return quantize_int8_plain(part)


def dequant_sum_quantize_int8(q: torch.Tensor, scale: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (tp, ..., d) int8 and scale (tp, ..., 1) fp32, rank t's shard of
    this rank's slice at index t -> (q2 (..., d) int8, s2 (..., 1) fp32):
    the slice's fp32 sum over the ranks, in rank order, quantized with B7's
    rule.  CPU (and meta) tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check_exchange("dequant_sum_quantize_int8", q, scale)
    if q.device.type in _PLAIN_DEVICES:
        return dequant_sum_quantize_int8_plain(q, scale)
    tp, d = q.shape[0], q.shape[-1]
    q = q.contiguous()
    scale = scale.contiguous()
    q2 = torch.empty(q.shape[1:], dtype=torch.int8, device=q.device)
    s2 = torch.empty(scale.shape[1:], dtype=torch.float32, device=q.device)
    R = q2.numel() // d
    if R == 0:
        return q2, s2
    plan, partial, (p, *launch) = _plan("dequant_sum_quantize_int8", R, d,
                                        q, q2, vec_bytes=8)
    _launch_check("dequant_sum_quantize_int8", native.library(
        _SOURCE).dequant_sum_quantize_int8(
        q.data_ptr(), scale.data_ptr(), q2.data_ptr(), s2.data_ptr(), p, R,
        d, tp, *launch, native.stream_of(q)), plan)
    return q2, s2


def dequantize_int8_gathered_plain(q: torch.Tensor, scale: torch.Tensor,
                                   dtype: torch.dtype) -> torch.Tensor:
    """Plain version: every rank's dequantized slice, side by side in rank
    order along the last dim, in ``dtype``."""
    out = dequantize_int8(q, scale, dtype)              # (tp, ..., d)
    return out.movedim(0, -2).reshape(*q.shape[1:-1],
                                      q.shape[0] * q.shape[-1])


def dequantize_int8_gathered(q: torch.Tensor, scale: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """q (tp, ..., d) int8 and scale (tp, ..., 1) fp32, rank t's slice at
    index t -> (..., tp * d) of ``dtype`` (float32 or bfloat16): element
    (..., t * d + j) is q[t, ..., j] * scale[t, ...], rounded to ``dtype``.
    CPU (and meta) tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_exchange("dequantize_int8_gathered", q, scale)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize_int8_gathered writes float32 or "
                        f"bfloat16, got {dtype}")
    if q.device.type in _PLAIN_DEVICES:
        return dequantize_int8_gathered_plain(q, scale, dtype)
    tp, d = q.shape[0], q.shape[-1]
    q = q.contiguous()
    scale = scale.contiguous()
    out = torch.empty((*q.shape[1:-1], tp * d), dtype=dtype, device=q.device)
    R = out.numel() // (tp * d)
    if R == 0:
        return out
    vec = d % 8 == 0 and q.data_ptr() % 8 == 0 and out.data_ptr() % 16 == 0
    _launch_check("dequantize_int8_gathered", native.library(
        _SOURCE).dequantize_int8_gathered(
        0 if dtype == torch.float32 else 1, q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), R, d, tp, int(vec), native.stream_of(q)))
    return out
