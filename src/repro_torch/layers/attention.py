"""GQA attention, local-shard view (port of ``repro/layers/attention.py``):
chunked prefill over a dense or paged prefix,
decode over the page pool or a dense padded cache, and whisper's
bidirectional encoder attention and cross-attention.

Forward functions take the local slice of the padded weights and return an
UNREDUCED partial output: the TP all-reduce after ``o_proj`` is the caller's
(the ISO scheduler decides when).  Layouts at the public functions are the
reference's: activations (B, S, D), heads (B, S, H, hd), page pools
(N+1, ps, Hkv, hd).  The dense einsums of ``sdpa_partial`` sit outside any
kernel in the reference too, so they are plain torch ops here, and so is
``sdpa_blockwise`` (``attn_impl="blockwise"``: an XLA scan in the
reference); the paged walks go through the hand-written kernels of
``repro_torch.kernels``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.mlp import matmul
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


def _head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    v = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(v + eps)) * scale).to(x.dtype)


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, use_rope: bool = True) -> Tuple:
    """x: (B,S,D) -> q (B,S,Hq_loc,hd), k/v (B,S,Hkv_loc,hd).

    ``positions``: (B,S) absolute positions (chunk offsets included)."""
    B, S, D = x.shape

    def proj(w):                                       # "bsd,dhk->bshk"
        return matmul(x, w.reshape(D, -1)).reshape(
            B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = _head_rms(q, p["q_norm"], cfg.rms_eps)
        k = _head_rms(k, p["k_norm"], cfg.rms_eps)
    if use_rope and cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def row_starts(start_pos, B: int, device) -> torch.Tensor:
    """Normalise a chunk start (int, 0-d tensor or per-row (B,) tensor) to a
    (B,) int32 tensor on ``device``.  An int becomes a device-side fill, not
    a host-to-device copy: a copy from pageable memory would wait for the
    card and stop the host from running ahead of it."""
    if isinstance(start_pos, torch.Tensor):
        s = start_pos.to(device=device, dtype=torch.int32)
        return s.expand(B).contiguous() if s.ndim == 0 else s
    return torch.full((B,), int(start_pos), dtype=torch.int32, device=device)


def row_positions(start_pos, B: int, S: int, device) -> torch.Tensor:
    """(B, S) absolute positions of S consecutive tokens from ``start_pos``."""
    return (row_starts(start_pos, B, device)[:, None]
            + torch.arange(S, dtype=torch.int32, device=device)[None, :])


def _k_limit_col(k_limit, device):
    """Broadcast a key-position bound (int, 0-d or per-row (B,) tensor)
    against (B, Sk) key positions."""
    if isinstance(k_limit, torch.Tensor):
        kl = k_limit.to(device=device, dtype=torch.int32)
        return kl[:, None] if kl.ndim == 1 else kl
    return int(k_limit)


def sdpa_partial(q, k, v, *, q_pos, k_pos, causal: bool = True,
                 window: int = 0, k_valid=None, group_eff: int = 1):
    """Scaled-dot-product attention with GQA grouping and an fp32 softmax
    that returns the flash partial state ``(out, m, l)``: out (B,Sq,Hq,hd) =
    acc/l fp32, m/l (B,Sq,Hq,1).  Fully-masked rows come back as
    (0, NEG_INF, 0), which ``merge_softmax_states`` then ignores exactly."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    assert Hq == Hkv * group_eff, (Hq, Hkv, group_eff)
    qg = q.reshape(B, Sq, Hkv, group_eff, hd)
    scale = hd ** -0.5
    s = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float()) * scale
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    mask_b = mask[:, None, None]                        # (B,1,1,Sq,Sk)
    s = torch.where(mask_b, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)             # (B,Hkv,g,Sq,1)
    # explicit mask multiply: a fully-masked row has s == m == NEG_INF and
    # exp(0) would otherwise leak weight 1 per masked key
    p = torch.exp(s - m) * mask_b
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgqs,bshk->bqhgk", p, v.float())

    def rows(t):                                        # (B,Hkv,g,Sq,1) -> (B,Sq,Hq,1)
        return t.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, 1)

    out = out.reshape(B, Sq, Hq, hd) / torch.clamp(rows(l), min=1e-30)
    return out, rows(m), rows(l)


def sdpa(q, k, v, **kw):
    """The normalised view of ``sdpa_partial`` (fully-masked rows -> 0)."""
    return sdpa_partial(q, k, v, **kw)[0]


def sdpa_blockwise(q, k, v, *, q_pos, k_pos, causal: bool = True,
                   window: int = 0, k_valid=None, group_eff: int = 1,
                   block_k: int = 1024):
    """Flash-style blockwise attention in plain torch: a loop over key
    blocks of ``block_k`` with a running fp32 (max, denominator,
    accumulator), O(Sq x block_k) live scores instead of O(Sq x Sk); the
    masks of ``sdpa`` (positions, causal, window, ``k_valid``).  At ``Sk <=
    block_k`` it is ``sdpa``, as the reference's.  Runs the reference's
    float ops in its order; it does not go through B4, which takes a scalar
    query start and no key mask."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    assert Hq == Hkv * group_eff, (Hq, Hkv, group_eff)
    if Sk <= block_k:
        return sdpa(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                    window=window, k_valid=k_valid, group_eff=group_eff)
    qg = q.reshape(B, Sq, Hkv, group_eff, hd).float()
    scale = hd ** -0.5
    dev = q.device
    m_run = torch.full((B, Hkv, group_eff, Sq), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hkv, group_eff, Sq), dtype=torch.float32,
                        device=dev)
    acc = torch.zeros((B, Hkv, group_eff, Sq, hd), dtype=torch.float32,
                      device=dev)
    for s0 in range(0, Sk, block_k):
        # the last block is short where the reference pads it with keys
        # at position -1, which its mask drops
        kb, vb = k[:, s0:s0 + block_k], v[:, s0:s0 + block_k]
        kpb = k_pos[:, s0:s0 + block_k]
        mask = (k_valid[:, s0:s0 + block_k] if k_valid is not None
                else kpb >= 0)[:, None, :]                   # (B,1,bk)
        if causal:
            mask = mask & (kpb[:, None, :] <= q_pos[:, :, None])
        if window:
            mask = mask & (kpb[:, None, :] > q_pos[:, :, None] - window)
        mask_b = mask[:, None, None]                         # (B,1,1,.,bk)
        s = torch.einsum("bqhgd,bshd->bhgqs", qg, kb.float()) * scale
        s = torch.where(mask_b, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        alpha = torch.exp(m_run - m_new)
        # explicit mask multiply: a fully-masked block has s == m_new ==
        # NEG_INF and exp(0) would leak weight 1 per masked key
        p = torch.exp(s - m_new[..., None]) * mask_b
        l_run = l_run * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqs,bshd->bhgqd", p,
                                                    vb.float())
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return torch.movedim(out, 3, 1).reshape(B, Sq, Hq, hd)


def merge_softmax_states(o_a, m_a, l_a, o_b, m_b, l_b):
    """Combine two flash partial-softmax states over disjoint key sets into
    the normalised output over their union, fp32.  A state with l == 0
    contributes nothing."""
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m) * l_a
    wb = torch.exp(m_b - m) * l_b
    return (o_a * wa + o_b * wb) / torch.clamp(wa + wb, min=1e-30)


def o_proj_partial(p: dict, attn_out: torch.Tensor,
                   x: torch.Tensor = None) -> torch.Tensor:
    """Row-parallel output projection; returns the UNREDUCED partial sum.
    With a gate ``wg`` (D, Hq, hd) among the weights (afmoe), the heads'
    output is first multiplied by sigmoid(x wg), in fp32, x the attention's
    (normed) input."""
    wo = p["wo"]
    B, S = attn_out.shape[:2]
    if "wg" in p:
        wg = p["wg"]
        gate = matmul(x, wg.reshape(wg.shape[0], -1)).reshape(
            attn_out.shape)
        attn_out = attn_out.float() * torch.sigmoid(gate.float())
    return torch.matmul(attn_out.to(wo.dtype).reshape(B, S, -1),
                        wo.reshape(-1, wo.shape[-1]))


# ---------------------------------------------------------------------------
# full blocks
# ---------------------------------------------------------------------------

def attn_prefill_partial(p: dict, x, cfg: ModelConfig, layout_group: int, *,
                         start_pos, prefix_kv: Optional[Tuple] = None,
                         prefix_pos=None, window: int = 0, causal: bool = True,
                         k_limit=None, rope: bool = True):
    """Chunked-prefill attention against a dense prefix (earlier ISO chunks
    of this call).  ``start_pos``: absolute position of the chunk's first
    token, int or per-row (B,).  ``prefix_pos``: optional (B, S_prefix)
    absolute positions of the prefix slots (-1 = empty); without it the
    prefix is contiguous from position 0.  ``k_limit``: keys at positions
    >= k_limit are masked (bucket-padded tails).  ``rope=False``: no
    rotary embedding (an afmoe full-attention layer, NoPE).  Returns
    (partial_out, (k, v) of THIS chunk)."""
    B, S, _ = x.shape
    dev = x.device
    q_pos = row_positions(start_pos, B, S, dev)
    q, k, v = project_qkv(p, x, cfg, q_pos, use_rope=rope)
    k_valid = None
    if prefix_kv is not None:
        pk, pv = prefix_kv
        k_all = torch.cat([pk, k], dim=1)
        v_all = torch.cat([pv, v], dim=1)
        if prefix_pos is not None:
            k_pos = torch.cat([prefix_pos.to(torch.int32), q_pos], dim=1)
            k_valid = torch.cat(
                [prefix_pos >= 0, torch.ones((B, S), dtype=torch.bool,
                                             device=dev)], dim=1)
        else:
            k_pos = torch.arange(k_all.shape[1], dtype=torch.int32,
                                 device=dev)[None, :].expand(B, -1)
    else:
        k_all, v_all, k_pos = k, v, q_pos
    if k_limit is not None:
        lim = k_pos < _k_limit_col(k_limit, dev)
        k_valid = lim if k_valid is None else (k_valid & lim)
    if cfg.attn_impl == "blockwise":
        out = sdpa_blockwise(q, k_all, v_all, q_pos=q_pos, k_pos=k_pos,
                             causal=causal, window=window, k_valid=k_valid,
                             group_eff=layout_group,
                             block_k=cfg.attn_block_k)
    elif cfg.attn_impl == "dense":
        out = sdpa(q, k_all, v_all, q_pos=q_pos, k_pos=k_pos, causal=causal,
                   window=window, k_valid=k_valid, group_eff=layout_group)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return o_proj_partial(p, out, x), (k, v)


def attn_prefill_paged_partial(p: dict, x, cfg: ModelConfig,
                               layout_group: int, *, k_pages, v_pages,
                               block_tables, prefix_lens, start_pos,
                               intra_kv: Optional[Tuple] = None,
                               intra_pos=None, window: int = 0, k_limit=None,
                               rope: bool = True):
    """Chunked-prefill attention against a PAGED KV prefix (no dense gather).

    x: (B,S,D) one ISO chunk; k_pages/v_pages: (N, ps, Hkv_loc, hd);
    block_tables: (B, MB) int32 (-1 pad); prefix_lens: (B,) int32 resident
    prefix tokens (key position j*ps+o attended iff < prefix_len).
    ``intra_kv``/``intra_pos``: (k, v) and positions of earlier ISO chunks of
    this call, not yet in pages.  The paged kernel
    (kernels/flash_prefill_paged.py) returns the partial state over the
    paged prefix; the intra-call keys are folded in with one dense
    partial-softmax merge.  Returns (partial_out, (k, v) of THIS chunk); the
    page scatter is the engine's job."""
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    B, S, _ = x.shape
    dev = x.device
    q_pos = row_positions(start_pos, B, S, dev)
    q, k, v = project_qkv(p, x, cfg, q_pos, use_rope=rope)
    q_starts = row_starts(start_pos, B, dev)
    out_p, m_p, l_p = flash_prefill_paged(
        q.transpose(1, 2).contiguous(), k_pages, v_pages, block_tables,
        prefix_lens, q_starts, window=window)
    out_p = out_p.transpose(1, 2)                       # (B,S,Hq,hd)
    m_p = m_p.transpose(1, 2)
    l_p = l_p.transpose(1, 2)
    if intra_kv is not None:
        ik, iv = intra_kv
        k_all = torch.cat([ik, k], dim=1)
        v_all = torch.cat([iv, v], dim=1)
        k_pos = torch.cat([intra_pos.to(torch.int32), q_pos], dim=1)
    else:
        k_all, v_all, k_pos = k, v, q_pos
    k_valid = (k_pos < _k_limit_col(k_limit, dev)) if k_limit is not None \
        else None
    out_i, m_i, l_i = sdpa_partial(q, k_all, v_all, q_pos=q_pos, k_pos=k_pos,
                                   causal=True, window=window,
                                   k_valid=k_valid, group_eff=layout_group)
    out = merge_softmax_states(out_p, m_p, l_p, out_i, m_i, l_i)
    return o_proj_partial(p, out, x), (k, v)


def attn_decode_paged_partial(p: dict, x, cfg: ModelConfig, layout_group: int,
                              *, k_pages, v_pages, block_tables, lengths,
                              window: int = 0, kv_splits: int = 1,
                              rope: bool = True):
    """Decode straight against the paged KV pool (no dense gather).

    x: (B,K,D), K=1 plain decode (window token qi sits at position
    ``lengths[b] + qi``); k_pages/v_pages: (N, ps, Hkv_loc, hd);
    block_tables: (B, MB) int32 (-1 pad); lengths: (B,) tokens resident.
    ``kv_splits`` > 1 walks the pages in S spans folded by the reduce kernel,
    so the state merged here is the same at every S.  The window's own
    (k, v), not yet scattered to pages, are folded in with one dense
    lower-triangular partial-softmax merge.  Returns (partial_out (B,K,D),
    (k_new, v_new)); the page scatter is the stack driver's job."""
    from repro_torch.kernels.flash_decode import flash_decode
    B, K = x.shape[0], x.shape[1]
    dev = x.device
    lengths = lengths.to(torch.int32)
    q_pos = lengths[:, None] + torch.arange(K, dtype=torch.int32,
                                            device=dev)[None]
    q, k_new, v_new = project_qkv(p, x, cfg, q_pos, use_rope=rope)
    out_p, m_p, l_p = flash_decode(q.contiguous(), k_pages, v_pages,
                                   block_tables, lengths, window=window,
                                   kv_splits=kv_splits)  # (B,K,Hq,·)
    out_i, m_i, l_i = sdpa_partial(q, k_new, v_new, q_pos=q_pos, k_pos=q_pos,
                                   causal=True, window=window,
                                   group_eff=layout_group)
    out = merge_softmax_states(out_p, m_p, l_p, out_i, m_i, l_i)
    return o_proj_partial(p, out, x), (k_new, v_new)


def attn_decode_partial(p: dict, x, cfg: ModelConfig, layout_group: int, *,
                        cache_k, cache_v, lengths, window: int = 0,
                        cache_pos=None, rope: bool = True):
    """Decode against a dense padded cache (the dense ``Engine``).

    x: (B,K,D), K=1 plain decode or a K-token verify window whose token qi
    sits at position ``lengths[b] + qi``; cache_k/v: (B,Smax,Hkv_loc,hd);
    lengths: (B,) tokens already cached.  ``cache_pos``: optional (B,Smax)
    absolute position of each slot (-1 = empty), needed for ring caches
    where slot != position.  The window's tokens attend the cache and,
    causally, each other.  Returns (partial_out, (k_new, v_new)); the cache
    insert is the stack driver's job."""
    B, K = x.shape[0], x.shape[1]
    dev = x.device
    lengths = lengths.to(torch.int32)
    q_pos = lengths[:, None] + torch.arange(K, dtype=torch.int32,
                                            device=dev)[None]
    q, k_new, v_new = project_qkv(p, x, cfg, q_pos, use_rope=rope)
    Smax = cache_k.shape[1]
    if cache_pos is not None:
        k_pos = cache_pos.to(torch.int32)
        k_valid = cache_pos >= 0
    else:
        k_pos = torch.arange(Smax, dtype=torch.int32,
                             device=dev)[None, :].expand(B, -1)
        k_valid = k_pos < lengths[:, None]
    k_all = torch.cat([cache_k, k_new], dim=1)
    v_all = torch.cat([cache_v, v_new], dim=1)
    k_pos = torch.cat([k_pos, q_pos], dim=1)
    k_valid = torch.cat([k_valid, torch.ones((B, K), dtype=torch.bool,
                                             device=dev)], dim=1)
    out = sdpa(q, k_all, v_all, q_pos=q_pos, k_pos=k_pos, causal=True,
               window=window, k_valid=k_valid, group_eff=layout_group)
    return o_proj_partial(p, out, x), (k_new, v_new)


def _zero_pos(B: int, S: int, device) -> torch.Tensor:
    return torch.zeros((B, S), dtype=torch.int32, device=device)


def attn_encode_partial(p: dict, x, cfg: ModelConfig, layout_group: int, *,
                        kv_full):
    """Bidirectional (encoder) attention: this chunk's queries attend the
    FULL sequence's (k, v), projected once per layer by the scheduler
    (core/iso.run_layer); position 0 everywhere, no RoPE."""
    B, S, _ = x.shape
    pos = _zero_pos(B, S, x.device)
    q, _, _ = project_qkv(p, x, cfg, pos, use_rope=False)
    k, v = kv_full
    out = sdpa(q, k, v, q_pos=pos, k_pos=_zero_pos(B, k.shape[1], x.device),
               causal=False, group_eff=layout_group)
    return o_proj_partial(p, out, x)


def attn_cross_partial(p: dict, x, cfg: ModelConfig, layout_group: int, *,
                       enc_k, enc_v, enc_valid=None):
    """Cross-attention (whisper decoder): queries from x, keys and values
    precomputed from the encoder output (``cross_kv``)."""
    B, S, _ = x.shape
    pos = _zero_pos(B, S, x.device)
    q, _, _ = project_qkv(p, x, cfg, pos, use_rope=False)
    out = sdpa(q, enc_k, enc_v, q_pos=pos,
               k_pos=_zero_pos(B, enc_k.shape[1], x.device), causal=False,
               k_valid=enc_valid, group_eff=layout_group)
    return o_proj_partial(p, out, x)


def cross_kv(p: dict, enc_out, cfg: ModelConfig):
    """Cross-attention K/V of the encoder output (no RoPE)."""
    B, S, _ = enc_out.shape
    _, k, v = project_qkv(p, enc_out, cfg, _zero_pos(B, S, enc_out.device),
                          use_rope=False)
    return k, v
