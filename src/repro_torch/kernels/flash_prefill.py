"""Dense flash-attention prefill with a causal offset: CUDA kernel, plain
version, wrapper.

Replaces the TPU kernel ``_flash_kernel`` of ``repro/kernels/
flash_prefill.py``, the paper's chunked-prefill primitive: the queries of one
sequence chunk attend the keys of the prefix and of the chunk itself, so

    flash(q[:c], k[:c], v[:c]) ++ flash(q[c:], k, v, q_start=c) == flash(q, k, v)

The reference reaches it only through ``kernels/ops.flash_attention``; its
model prefill uses plain attention (``layers/attention.py``, in both
packages).  The kernel is in ``csrc/flash_prefill.cu``.

Layout (the reference's): q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd), one
type, float32 or bfloat16; q head h reads kv head ``h // (Hq // Hkv)``.
Query row i sits at position ``q_start + i``; key j is attended iff
``j < Sk``, and ``j <= q_start + i`` when causal, and ``j > q_start + i -
window`` when ``window > 0``.  The output is softmax-normalised, in q's
type.  A row with no attended key (``q_start + i >= Sk - 1 + window``)
comes out 0, as ``repro/kernels/ref.flash_prefill_ref`` gives it; the Pallas
kernel does not mask ``p`` and leaves a value there that depends on its
padding.  Every row with an attended key matches it.

On the card one block owns a query tile of one (b, q head) and walks
64-key tiles, skipping those wholly above the causal diagonal or below the
window; bound by operations (4 * hd FLOPs per attended pair).  The dtype
picks the instantiation: bfloat16 runs the tensor-core tile loop of
``csrc/flash_tc.cuh`` (mma.sync on bf16 tiles fed by cp.async, fp32 sums,
p rounded to bf16 before p @ v; 128-query tiles, 102 KB of shared memory,
up to hd 128, 64-query tiles above), float32 the fp32 CUDA-core kernel
(64-query tiles, 216.8 KB at hd 256).  Both are launched and held against
the plain version on the card; neither is a fallback for the other.
Limit: ``hd <= 256``.

``flash_attention_plain`` follows ``flash_prefill_ref``; the wrapper uses it
only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

_SOURCE = "flash_prefill.cu"


def flash_attention_plain(q, k, v, *, q_start: int = 0, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain version of the kernel."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * (hd ** -0.5)
    q_pos = q_start + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def flash_attention(q, k, v, *, q_start: int = 0, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Flash attention of q (B, Hq, Sq, hd) over k, v (B, Hkv, Sk, hd) with
    the causal offset ``q_start`` and an optional sliding ``window`` (the
    reference's signature minus the TPU's ``block_q``/``block_k``/
    ``interpret``).  Returns (B, Hq, Sq, hd) in q's dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel: the tensor-core one
    for bfloat16, the CUDA-core one for float32."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes q, k, v of one type, float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} (B, Hq, Sq, "
                         f"hd) and k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"(B, Hkv, Sk, hd) do not agree")
    if q.shape[3] > native.MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {q.shape[3]} > "
                         f"{native.MAX_HEAD_DIM}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_start=q_start, causal=causal,
                                     window=window)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = native.library(_SOURCE).flash_prefill(
        native.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, int(q_start), int(causal),
        int(window), int(native.cp_async_ok(hd, q, k, v)), hd ** -0.5,
        native.stream_of(q))
    native.check_launch("flash_prefill", err)
    native.count_launch("flash_prefill", q.dtype)
    return out
