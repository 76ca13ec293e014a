"""Paged flash-decode over block tables: CUDA kernels, plain versions, wrapper.

Replaces the TPU kernels of ``repro/kernels/flash_decode.py``:
``_decode_kernel`` (the span walk) and ``_decode_reduce_kernel`` (the
split-KV fold).  Both kernels are in ``csrc/paged_attention.cu``; at S > 1
spans the serving path runs the fold inside the decode launch.

Layout (the reference's; the period dim of the pool is the caller's):

    q            (B, Hq, hd) one decode token per request, or
                 (B, K, Hq, hd) a K-token window (token qi at lengths[b] + qi)
    k/v pages    (N, ps, Hkv, hd) page pool, float32 or bfloat16
    block_tables (B, MB) int32, -1 pad (aliases page 0, always masked)
    lengths      (B,) int32 tokens resident

On the card the decode kernel is bound by bytes (every resident K/V page is
read once per step; a query row does ~4 FLOPs per byte), so its design keeps
bytes in flight and every lane busy.  A block of 8 warps takes each (span,
kv head, request, 4 of the ``gk = group*K`` query rows, row ``g*K + qi``).
The warps split the span's pages round-robin; each walks its pages through a
cp.async ring of its own (16-byte loads, two 8 KB batches in flight while it
computes a third) with the running softmax state of the 4 rows in registers,
fp32 for both dtypes: a lane owns 8 head dims of a key, and a shuffle
reduce-scatter over the key's lanes completes the scores.  The warps then
merge in warp order with the ``merge_softmax_states`` rule, and the block
writes the span's fp32 partial ``(acc/l, m, l)``.  When the grid is short (one
long request, one rank's heads) the launch puts a cluster of 2-8 blocks on
each span, merged through distributed shared memory: still one partial a
span.  Pages past the resident length are skipped, bit-identically (the
assignment and merge order do not depend on the skip).

With S > 1 spans, ``decode_folded`` (what ``flash_decode`` calls) folds the
partials inside the same launch: each block writes its partial to scratch
and counts itself in on an arrival counter of its (request, kv head, row
tile); the last block of a tile folds the tile's S partials, in span order,
with the same ``__device__`` code as the standalone reduce kernel
(``decode_reduce``, kept for the partials ``decode_partials`` returns), so
both give the same bits.  The counters (``ROW_TILE`` rows a tile) live on
the device for the life of the process, are 0 between launches, and grow
with the grid.  At S = 1 the walk's state is final and nothing is folded.
Limit: ``hd <= 256``, checked from the shapes before any dispatch, so the CPU
path refuses it too.  Any number of query rows: each 4-row tile is a block.

The plain versions (``decode_partials_plain``, ``decode_reduce_plain``)
compute the same functions with dense gathers, following
``repro/kernels/ref.paged_decode_split_ref``; the wrappers use them only for
CPU tensors.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.kernels import native

NEG_INF = -1e30
# query rows of a decode block (kDecRows): the fold's arrivals count per tile
ROW_TILE = 4
# the fold's arrival counters by device, and those a larger grid replaced
# (kept: a captured CUDA graph may still point at them)
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def decode_partials_plain(qg, k_pages, v_pages, block_tables, lengths, *,
                          k_tokens: int, window: int, kv_splits: int):
    """Plain version of the decode kernel.  qg: (B, Hkv, gk, hd) query rows
    (row r = g*K + qi).  Returns the per-span fp32 partial state
    ``(out, m, l)`` shaped (B, Hkv, S, gk, hd) / (B, Hkv, S, gk, 1); an empty
    span is (0, NEG_INF, 0)."""
    B, Hkv, gk, hd = qg.shape
    N, ps = k_pages.shape[:2]
    MB = block_tables.shape[1]
    S = kv_splits
    pps = -(-MB // S)
    idx = block_tables.long().clamp(0, N - 1)
    if S * pps > MB:                       # ragged last span: alias page 0
        idx = F.pad(idx, (0, S * pps - MB))
    L = pps * ps
    kd = k_pages[idx].reshape(B, S, L, Hkv, hd).float()
    vd = v_pages[idx].reshape(B, S, L, Hkv, hd).float()
    s = torch.einsum("bhrd,bslhd->bhsrl", qg.float(), kd) * (hd ** -0.5)
    k_pos = torch.arange(S * L, device=qg.device).reshape(1, 1, S, 1, L)
    length = lengths.long().reshape(B, 1, 1, 1, 1)
    mask = k_pos < length                                  # (B,1,S,1,L)
    if window:
        qi = (torch.arange(gk, device=qg.device) % k_tokens).reshape(
            1, 1, 1, gk, 1)
        mask = mask & (k_pos > length + qi - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    # slots past the length are selected away, not multiplied by p = 0: a
    # page's tail may hold anything (no pos pool scrubs it), NaN included
    vd = torch.where((k_pos < length).reshape(B, S, L, 1, 1), vd,
                     torch.zeros_like(vd))
    out = torch.einsum("bhsrl,bslhd->bhsrd", p, vd) / torch.clamp(l, min=1e-30)
    return out, m, l


def _check_decode(qg, k_pages, v_pages, block_tables, lengths) -> None:
    """The decode wrappers' checks, on either device: the shared input
    checks, shapes that agree, and the kernel's head-dim limit."""
    native.check_inputs(qg, k_pages, v_pages, block_tables, lengths,
                        "paged_decode")
    B, Hkv, gk, hd = qg.shape
    if tuple(k_pages.shape[2:]) != (Hkv, hd) or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"paged_decode: q rows {tuple(qg.shape)}, pool "
                         f"{tuple(k_pages.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not agree")
    if hd > native.MAX_HEAD_DIM:
        raise ValueError(f"paged_decode: head_dim {hd} past the kernel's "
                         f"limit {native.MAX_HEAD_DIM}")


def _launch(qg, k_pages, v_pages, block_tables, lengths, ptrs, arrivals, *,
            k_tokens, window, kv_splits, guard_dead_pages):
    """Launch B1: ``ptrs`` are the data pointers of the span partials (out,
    m, l) and of the folded state (out, m, l; 0s without the fold), and
    ``arrivals`` that of the fold's counters (0 without it)."""
    B, Hkv, gk, hd = qg.shape
    N, ps = k_pages.shape[:2]
    MB = block_tables.shape[1]
    S = kv_splits
    qg = qg.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    err = native.library().paged_decode(
        native.dtype_code(qg), qg.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), bt.data_ptr(), ln.data_ptr(), *ptrs, arrivals,
        B, Hkv, gk, k_tokens, hd, N, ps, MB, S, -(-MB // S), int(window),
        int(bool(guard_dead_pages)),
        int(native.cp_async_ok(hd, qg, k_pages, v_pages)), hd ** -0.5,
        native.stream_of(qg))
    native.check_launch("paged_decode", err)
    native.LAUNCHES["paged_decode"] += 1
    if k_tokens > 1:
        native.VARIANTS["paged_decode/verify"] += 1


def _state(shape, hd, device):
    """Uninitialised fp32 ``(out, m, l)`` of ``shape + (hd,)`` / ``(1,)``."""
    out = torch.empty((*shape, hd), dtype=torch.float32, device=device)
    m = torch.empty((*shape, 1), dtype=torch.float32, device=device)
    return out, m, torch.empty_like(m)


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` of the fold's arrival counters on ``device``, all 0."""
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[device] = buf
    return buf


def decode_partials(qg, k_pages, v_pages, block_tables, lengths, *,
                    k_tokens: int, window: int, kv_splits: int,
                    guard_dead_pages: bool = True):
    """Per-span partial state of the paged decode walk (see module doc).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Raises ValueError past the kernel's head-dim limit on either device."""
    _check_decode(qg, k_pages, v_pages, block_tables, lengths)
    S = kv_splits
    if qg.device.type == "cpu":
        return decode_partials_plain(qg, k_pages, v_pages, block_tables,
                                     lengths, k_tokens=k_tokens,
                                     window=window, kv_splits=S)
    B, Hkv, gk, hd = qg.shape
    out, m, l = _state((B, Hkv, S, gk), hd, qg.device)
    _launch(qg, k_pages, v_pages, block_tables, lengths,
            (out.data_ptr(), m.data_ptr(), l.data_ptr(), 0, 0, 0), 0,
            k_tokens=k_tokens, window=window, kv_splits=S,
            guard_dead_pages=guard_dead_pages)
    return out, m, l


def decode_folded(qg, k_pages, v_pages, block_tables, lengths, *,
                  k_tokens: int, window: int, kv_splits: int,
                  guard_dead_pages: bool = True):
    """The paged decode walk's state with its S span partials folded:
    (B, Hkv, gk, hd) / (B, Hkv, gk, 1) fp32.  On the card one launch at any
    S: at S > 1 the last block of each row tile folds the tile's partials
    (see module doc).  CPU tensors take the plain versions, the walk and
    then the fold.  Raises ValueError past the head-dim limit on either
    device."""
    S = kv_splits
    if S == 1:
        out, m, l = decode_partials(qg, k_pages, v_pages, block_tables,
                                    lengths, k_tokens=k_tokens,
                                    window=window, kv_splits=1,
                                    guard_dead_pages=guard_dead_pages)
        return out[:, :, 0], m[:, :, 0], l[:, :, 0]
    _check_decode(qg, k_pages, v_pages, block_tables, lengths)
    if qg.device.type == "cpu":
        return decode_reduce_plain(*decode_partials_plain(
            qg, k_pages, v_pages, block_tables, lengths, k_tokens=k_tokens,
            window=window, kv_splits=S))
    B, Hkv, gk, hd = qg.shape
    # the span partials' scratch, one allocation (held until the launch is
    # queued): out, then m, then l
    n = B * Hkv * S * gk
    scratch = torch.empty(n * (hd + 2), dtype=torch.float32,
                          device=qg.device)
    p = scratch.data_ptr()
    out, m, l = _state((B, Hkv, gk), hd, qg.device)
    _launch(qg, k_pages, v_pages, block_tables, lengths,
            (p, p + 4 * n * hd, p + 4 * n * (hd + 1),
             out.data_ptr(), m.data_ptr(), l.data_ptr()),
            _arrivals(qg.device, B * Hkv * -(-gk // ROW_TILE)).data_ptr(),
            k_tokens=k_tokens, window=window, kv_splits=S,
            guard_dead_pages=guard_dead_pages)
    native.VARIANTS["paged_decode/fold"] += 1
    return out, m, l


def decode_reduce_plain(out, m, l):
    """Plain version of the reduce kernel: (B, Hkv, S, gk, .) span partials
    -> (B, Hkv, gk, .) folded state."""
    m_max = torch.amax(m, dim=2)                          # (B,Hkv,gk,1)
    w = torch.exp(m - m_max[:, :, None]) * l              # (B,Hkv,S,gk,1)
    l_sum = torch.sum(w, dim=2)
    o = torch.sum(out * w, dim=2) / torch.clamp(l_sum, min=1e-30)
    return o, m_max, l_sum


def decode_reduce(out, m, l):
    """Fold S span partials into one state (the second phase of
    Flash-Decoding), as a launch of its own: the fold that ``decode_folded``
    runs inside the decode launch, over given partials.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    B, Hkv, S, gk, hd = out.shape
    if m.shape != (B, Hkv, S, gk, 1) or l.shape != m.shape:
        raise ValueError(f"decode_reduce: partials {tuple(out.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)} do not agree")
    for name, t in (("out", out), ("m", m), ("l", l)):
        if t.dtype != torch.float32 or t.device != out.device:
            raise TypeError(f"decode_reduce: {name} must be float32 on "
                            f"{out.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_reduce: {name} must be contiguous")
    if out.device.type == "cpu":
        return decode_reduce_plain(out, m, l)
    o2, m2, l2 = _state((B, Hkv, gk), hd, out.device)
    err = native.library().decode_reduce(
        out.data_ptr(), m.data_ptr(), l.data_ptr(), o2.data_ptr(),
        m2.data_ptr(), l2.data_ptr(), B, Hkv, S, gk, hd,
        native.stream_of(out))
    native.check_launch("decode_reduce", err)
    native.LAUNCHES["decode_reduce"] += 1
    return o2, m2, l2


def flash_decode(q, k_pages, v_pages, block_tables, lengths, *,
                 window: int = 0, kv_splits: int = 1,
                 guard_dead_pages: bool = True):
    """Paged flash attention for a decode window per request (the
    reference's signature and return layout).

    ``kv_splits`` partitions each request's page walk into S contiguous
    spans of ``ceil(MB/S)`` pages (clamped to the table width; S=1 is the
    sequential walk, no fold), folded inside the one decode launch.  Returns ``(out, m, l)`` fp32 partial
    softmax state over the paged keys: (B, Hq, hd)/(B, Hq, 1) for 3-D q and
    (B, K, Hq, hd)/(B, K, Hq, 1) for 4-D q.  Rows with ``lengths == 0`` come
    back as (0, NEG_INF, 0)."""
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    B, K, Hq, hd = q.shape
    Hkv = k_pages.shape[2]
    MB = block_tables.shape[1]
    if Hq % Hkv:
        raise ValueError(f"flash_decode: Hq={Hq} not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    gk = group * K
    S = max(1, min(int(kv_splits), MB))
    # query-row layout r = g*K + qi
    qg = q.reshape(B, K, Hkv, group, hd).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, gk, hd)
    out, m, l = decode_folded(qg, k_pages, v_pages, block_tables, lengths,
                              k_tokens=K, window=window, kv_splits=S,
                              guard_dead_pages=guard_dead_pages)

    def unrow(t, last):
        t = t.reshape(B, Hkv, group, K, last).permute(0, 3, 1, 2, 4)
        t = t.reshape(B, K, Hq, last)
        return t[:, 0] if squeeze else t

    return unrow(out, hd), unrow(m, 1), unrow(l, 1)
