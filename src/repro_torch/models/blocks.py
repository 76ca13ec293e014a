"""Block stage functions, the unit the ISO scheduler drives (port of the dense
subset of ``repro/models/blocks.py``).

A layer is a list of stages; each maps a chunk of the residual stream to an
output that NEEDS the TP all-reduce (``reduces=True``).  The scheduler
(core/iso.py) owns residual adds and collective timing, so blocks never
reduce.  Sequential per-stage state: attention carries the growing (k, v)
prefix of the call; the MLP carries none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config import BLOCK_ATTN_MLP, ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers.norms import norm


@dataclass
class StageCtx:
    cfg: ModelConfig
    group_eff: int                     # local GQA group (q slots per kv slot)
    mode: str = "prefill"              # prefill | decode
    window: int = 0
    # decode: (B,) cached token counts; paged prefill: (B,) prefix lengths
    lengths: Optional[torch.Tensor] = None
    # absolute position of this call's first token: int, 0-d or per-row
    # (B,) tensor (a compiled closure's device scalar)
    pos_offset: Any = 0
    # paged attention: (B, MB) int32 page ids per request, and the (B,) bool
    # mask of slots really decoding this step
    block_tables: Optional[torch.Tensor] = None
    decode_mask: Optional[torch.Tensor] = None
    # split-KV flash-decode: spans of each request's page walk
    kv_splits: int = 1
    # grant-size bucketing: REAL tokens in this call (int, 0-d or (B,)
    # tensor); call positions >= valid_len are pad, never attended as keys.
    # None = no pad
    valid_len: Any = None


def _n1(p, x, cfg):
    return norm(p["norm1"], x, cfg.norm_type, cfg.rms_eps)


def _n2(p, x, cfg):
    return norm(p["norm2"], x, cfg.norm_type, cfg.rms_eps)


def _prefill_attn(p_attn, xn, kv_state, cache, sctx: StageCtx, start_pos, B):
    """One chunk's prefill attention, dispatched on the cache layout.

    A cache with ``k_pages``/``v_pages`` means the persistent prefix lives in
    the page pool: the chunk attends it in place through the paged
    flash-prefill kernel, and only the intra-call KV (``kv_state``, earlier
    ISO chunks of this call) is attended densely.  Otherwise (a fresh grant)
    the prefix is the intra-call KV alone.  Returns (partial, kv of this
    chunk)."""
    cfg = sctx.cfg
    dev = xn.device
    k_limit = None
    if sctx.valid_len is not None:
        k_limit = sctx.pos_offset + sctx.valid_len
    if cache is not None and "k_pages" in cache:
        intra_pos = None
        if kv_state is not None:
            intra_pos = attn_lib.row_positions(sctx.pos_offset, B, start_pos,
                                               dev)
        return attn_lib.attn_prefill_paged_partial(
            p_attn, xn, cfg, sctx.group_eff,
            k_pages=cache["k_pages"], v_pages=cache["v_pages"],
            block_tables=sctx.block_tables, prefix_lens=sctx.lengths,
            start_pos=sctx.pos_offset + start_pos, intra_kv=kv_state,
            intra_pos=intra_pos, window=sctx.window, k_limit=k_limit)
    prefix_pos = None
    if kv_state is not None:
        prefix_pos = attn_lib.row_positions(sctx.pos_offset, B, start_pos, dev)
    return attn_lib.attn_prefill_partial(
        p_attn, xn, cfg, sctx.group_eff,
        start_pos=sctx.pos_offset + start_pos, prefix_kv=kv_state,
        prefix_pos=prefix_pos, window=sctx.window, k_limit=k_limit)


def attn_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    if sctx.mode == "decode":
        if cache is None or "k_pages" not in cache:
            raise NotImplementedError(
                "dense-cache decode: the port decodes through the page pool "
                "only (ROADMAP queue A item 6)")
        partial, kv_new = attn_lib.attn_decode_paged_partial(
            p["attn"], xn, cfg, sctx.group_eff,
            k_pages=cache["k_pages"], v_pages=cache["v_pages"],
            block_tables=sctx.block_tables, lengths=sctx.lengths,
            window=sctx.window, kv_splits=sctx.kv_splits)
        return partial, seq_state, {"kv": kv_new}
    partial, kv_new = _prefill_attn(p["attn"], xn, seq_state, cache, sctx,
                                    start_pos, x.shape[0])
    if seq_state is None:
        new_state = kv_new
    else:
        new_state = (torch.cat([seq_state[0], kv_new[0]], dim=1),
                     torch.cat([seq_state[1], kv_new[1]], dim=1))
    return partial, new_state, {"kv": kv_new}


def mlp_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    xn = _n2(p, x, sctx.cfg)
    return mlp_lib.mlp_partial(p["mlp"], xn, sctx.cfg.mlp_type), seq_state, {}


# kind -> ((stage_fn, reduces), ...)
BLOCK_STAGES = {
    BLOCK_ATTN_MLP: ((attn_stage, True), (mlp_stage, True)),
}
