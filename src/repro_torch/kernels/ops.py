"""The port's kernel entry point, the counterpart of ``repro/kernels/ops.py``.

One function per hand-written kernel, with the reference's names and
semantic keywords; the TPU's tiling and interpreter keywords (``block_q``,
``block_k``, ``block_rows``, ``block_cols``, ``interpret``) do not carry
over, since each CUDA kernel picks its own tiles and states its own limits.
There is no dispatcher and no fallback: a CPU tensor takes the kernel's
plain version, a CUDA tensor launches the kernel or raises.

    flash_attention(q, k, v, *, q_start=0, causal=True, window=0)  B4
    rms_norm(x, gamma, *, eps=1e-6)                                B5
    swiglu(gate, up)                                               B6
    quantize_int8(x)                                               B7
"""
from __future__ import annotations

from repro_torch.kernels.flash_prefill import flash_attention
from repro_torch.kernels.int8_quant import quantize_int8
from repro_torch.kernels.rmsnorm import rms_norm
from repro_torch.kernels.swiglu import swiglu

__all__ = ["flash_attention", "quantize_int8", "rms_norm", "swiglu"]
