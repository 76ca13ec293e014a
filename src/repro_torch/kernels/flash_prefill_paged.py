"""Paged flash-prefill over block tables: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``repro/kernels/flash_prefill_paged.py::
_prefill_kernel``: one prefill chunk attends its request's page-resident KV
prefix in place.  The kernel is in ``csrc/paged_attention.cu``.

Layout (the reference's):

    q            (B, Hq, Sq, hd)    one prefill chunk per request
    k/v pages    (N, ps, Hkv, hd)   page pool, float32 or bfloat16
    block_tables (B, MB) int32      page ids, -1 pad (aliases page 0)
    prefix_lens  (B,)    int32      key position j*ps + o attended iff < it
    q_starts     (B,)    int32      absolute position of q[:, :, 0]

Every per-row input is heterogeneous; a row with ``prefix_len == 0`` comes
back as the neutral state (0, NEG_INF, 0).  On the card one thread block
handles (request, kv head, query block) with the ``group * block_q`` query
rows of that kv head's group (row ``g*block_q + i``), so each K/V tile is
read once per group.  The TPU's ``block_q=128`` does not fit: with group 4
and head_dim 128 its fp32 accumulator alone is 256 KB, over the 227 KB a
block may use, so the card takes ``block_q = max(1, 64 // group)`` rows per
kv-head group member and leaves the rows past Sq unwritten.  Keys past
``prefix_len`` are skipped (the reference walks all MB pages; the skip is
exact since such keys are wholly masked).  What bounds it on the card is
operations (2*2*Sq*prefix*Hq*hd FLOPs against one read of the prefix).

The dtype picks the instantiation: bfloat16 runs the tensor-core tile loop
of ``csrc/flash_tc.cuh`` (64 rows a block, 64-key tiles gathered through the
block table by cp.async, mma.sync with fp32 sums, p rounded to bf16 before
p @ v, the rows' softmax state in registers); float32 runs the CUDA-core
page loop with the state in shared memory, fp32 throughout.  Both are
launched and held against the plain version on the card; neither is a
fallback for the other.

``prefill_partial_plain`` computes the same function with a dense gather,
following ``repro/kernels/ref.paged_prefill_ref``; the wrapper uses it only
for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash_decode import NEG_INF

# query rows per thread block on the card (group * block_q)
BLOCK_ROWS = 64


def prefill_partial_plain(q, k_pages, v_pages, block_tables, prefix_lens,
                          q_starts, *, window: int = 0):
    """Plain version of the paged prefill kernel; returns fp32 ``(out, m,
    l)`` shaped (B, Hq, Sq, hd) / (B, Hq, Sq, 1)."""
    B, Hq, Sq, hd = q.shape
    N, ps, Hkv, _ = k_pages.shape
    MB = block_tables.shape[1]
    group = Hq // Hkv
    idx = block_tables.long().clamp(0, N - 1)
    kd = k_pages[idx].reshape(B, MB * ps, Hkv, hd).float()
    vd = v_pages[idx].reshape(B, MB * ps, Hkv, hd).float()
    qg = q.reshape(B, Hkv, group, Sq, hd).float()
    s = torch.einsum("bhgqd,bshd->bhgqs", qg, kd) * (hd ** -0.5)
    k_pos = torch.arange(MB * ps, device=q.device).reshape(1, 1, 1, 1, -1)
    mask = k_pos < prefix_lens.long().reshape(B, 1, 1, 1, 1)
    if window:
        q_pos = (q_starts.long().reshape(B, 1)
                 + torch.arange(Sq, device=q.device)[None]).reshape(
                     B, 1, 1, Sq, 1)
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgqs,bshd->bhgqd", p, vd) / torch.clamp(l, min=1e-30)
    return (out.reshape(B, Hq, Sq, hd), m.reshape(B, Hq, Sq, 1),
            l.reshape(B, Hq, Sq, 1))


def flash_prefill_paged(q, k_pages, v_pages, block_tables, prefix_lens,
                        q_starts, *, window: int = 0):
    """Paged flash attention of one prefill chunk against its KV prefix
    (the reference's signature minus the TPU's ``block_q``/``interpret``).

    Returns ``(out, m, l)`` fp32 partial softmax state over the paged
    prefix: out (B, Hq, Sq, hd) = acc/l, m and l (B, Hq, Sq, 1).  CPU
    tensors take the plain version; CUDA tensors launch the kernel: the
    tensor-core one for bfloat16, the CUDA-core one for float32."""
    native.check_inputs(q, k_pages, v_pages, block_tables, prefix_lens,
                        "paged_prefill")
    B, Hq, Sq, hd = q.shape
    N, ps, Hkv, hd_p = k_pages.shape
    MB = block_tables.shape[1]
    if hd_p != hd or Hq % Hkv or block_tables.shape[0] != B \
            or prefix_lens.shape != (B,) or q_starts.shape != (B,) \
            or q_starts.device != q.device:
        raise ValueError(f"paged_prefill: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}, prefix_lens "
                         f"{tuple(prefix_lens.shape)}, q_starts "
                         f"{tuple(q_starts.shape)} do not agree")
    if q.device.type == "cpu":
        return prefill_partial_plain(q, k_pages, v_pages, block_tables,
                                     prefix_lens, q_starts, window=window)
    group = Hq // Hkv
    bq = max(1, BLOCK_ROWS // group)
    if q.dtype == torch.float32:
        native.check_smem(group * bq, ps, hd, "paged_prefill")
    elif hd > native.MAX_HEAD_DIM:      # every bf16 block up to it fits
        raise ValueError(f"paged_prefill: head_dim {hd} > "
                         f"{native.MAX_HEAD_DIM}")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pl = prefix_lens.to(torch.int32).contiguous()
    qs = q_starts.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = native.library().paged_prefill(
        native.dtype_code(q), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), bt.data_ptr(), pl.data_ptr(), qs.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, group, Sq, hd, N,
        ps, MB, bq, int(window),
        int(native.cp_async_ok(hd, q, k_pages, v_pages)), hd ** -0.5,
        native.stream_of(q))
    native.check_launch("paged_prefill", err)
    native.count_launch("paged_prefill", q.dtype)
    return out, m, l
