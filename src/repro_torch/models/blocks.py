"""Block stage functions, the unit the ISO scheduler drives (port of
``repro/models/blocks.py``: ``attn_mlp``, ``attn_moe``, hymba's ``hybrid``,
xLSTM's ``mlstm`` and ``slstm``, and whisper's ``dec_block``; and the afmoe
kinds, which the reference does not have).

A layer is a list of stages; each maps a chunk of the residual stream to an
output that either NEEDS the TP all-reduce (``reduces=True``, an unreduced
partial) or is already whole (the sLSTM, whose weights are replicated).
The scheduler (core/iso.py) owns residual adds and collective timing, so
blocks never reduce.  Sequential per-stage state, the cross-chunk edge ISO
keeps: attention carries the growing (k, v) prefix of the call (in
``encode`` mode, the whole sequence's); ``hybrid`` the pair (that prefix,
its ``SSMState``); ``mlstm``/``slstm`` their ``MLSTMState``/``SLSTMState``;
cross-attention, the MLP and the MoE FFN carry none.  A recurrent stage's
first chunk starts from ``cache[ssm|mlstm|slstm]`` when the cache has one
(a decode step, or a resumed grant's carry), else from zero state.

An afmoe stage (``AFMOE_KINDS``) norms its output again before the
residual add (the "sandwich" norm), which needs the whole, reduced output:
its extras carry ``post``, the function the scheduler applies to the
reduced partial before adding it (core/iso.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config import BLOCK_AF_FULL_MLP, BLOCK_AF_FULL_MOE, \
    BLOCK_AF_SWA_MLP, BLOCK_AF_SWA_MOE, BLOCK_ATTN_MLP, BLOCK_ATTN_MOE, \
    BLOCK_DEC, BLOCK_HYBRID, BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import ssm as ssm_lib
from repro_torch.layers import xlstm as xlstm_lib
from repro_torch.layers.norms import norm


@dataclass
class StageCtx:
    cfg: ModelConfig
    group_eff: int                     # local GQA group (q slots per kv slot)
    tp: int = 1
    expert_offset: int = 0             # first global expert id of this rank
    mode: str = "prefill"              # prefill | decode | encode
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


def _prefill_attn(p_attn, xn, kv_state, cache, sctx: StageCtx, start_pos, B,
                  window: Optional[int] = None, rope: bool = True):
    """One chunk's prefill attention, dispatched on the cache layout.

    A cache with ``k_pages``/``v_pages`` means the persistent prefix lives in
    the page pool: the chunk attends it in place through the paged
    flash-prefill kernel, and only the intra-call KV (``kv_state``, earlier
    ISO chunks of this call) is attended densely.  Otherwise (a fresh grant)
    the prefix is the intra-call KV alone.  ``window`` (default the
    model's) and ``rope``: the layer's own (afmoe).  Returns (partial, kv
    of this chunk)."""
    cfg = sctx.cfg
    dev = xn.device
    window = sctx.window if window is None else window
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
            intra_pos=intra_pos, window=window, k_limit=k_limit, rope=rope)
    prefix_pos = None
    if kv_state is not None:
        prefix_pos = attn_lib.row_positions(sctx.pos_offset, B, start_pos, dev)
    return attn_lib.attn_prefill_partial(
        p_attn, xn, cfg, sctx.group_eff,
        start_pos=sctx.pos_offset + start_pos, prefix_kv=kv_state,
        prefix_pos=prefix_pos, window=window, k_limit=k_limit, rope=rope)


def _decode_attn(p_attn, xn, sctx: StageCtx, cache,
                 window: Optional[int] = None, rope: bool = True):
    """One decode window's attention over the page pools or a dense ring
    cache; returns (partial, the window's kv).  ``window`` and ``rope`` as
    ``_prefill_attn``'s."""
    cfg = sctx.cfg
    window = sctx.window if window is None else window
    if "k_pages" in cache:
        return attn_lib.attn_decode_paged_partial(
            p_attn, xn, cfg, sctx.group_eff,
            k_pages=cache["k_pages"], v_pages=cache["v_pages"],
            block_tables=sctx.block_tables, lengths=sctx.lengths,
            window=window, kv_splits=sctx.kv_splits, rope=rope)
    return attn_lib.attn_decode_partial(
        p_attn, xn, cfg, sctx.group_eff,
        cache_k=cache["k"], cache_v=cache["v"], lengths=sctx.lengths,
        window=window, cache_pos=cache.get("pos"), rope=rope)


def _grow_kv(kv_state, kv_new):
    if kv_state is None:
        return kv_new
    return (torch.cat([kv_state[0], kv_new[0]], dim=1),
            torch.cat([kv_state[1], kv_new[1]], dim=1))


def attn_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    if sctx.mode == "decode":
        partial, kv_new = _decode_attn(p["attn"], xn, sctx, cache)
        return partial, seq_state, {"kv": kv_new}
    if sctx.mode == "encode":
        # seq_state holds the full sequence's (k, v), projected by the
        # scheduler before the unit loop (core/iso.run_layer)
        partial = attn_lib.attn_encode_partial(
            p["attn"], xn, cfg, sctx.group_eff, kv_full=seq_state)
        return partial, seq_state, {}
    partial, kv_new = _prefill_attn(p["attn"], xn, seq_state, cache, sctx,
                                    start_pos, x.shape[0])
    return partial, _grow_kv(seq_state, kv_new), {"kv": kv_new}


def cross_attn_stage(p, x, start_pos, seq_state, sctx: StageCtx,
                     cache=None):
    """Whisper decoder cross-attention over the encoder's K/V, which ride in
    ``cache`` (``cross_k``/``cross_v``): the prefill's layer statics, or the
    decode caches."""
    cfg = sctx.cfg
    xn = norm(p["norm_cross"], x, cfg.norm_type, cfg.rms_eps)
    partial = attn_lib.attn_cross_partial(
        p["cross"], xn, cfg, sctx.group_eff,
        enc_k=cache["cross_k"], enc_v=cache["cross_v"])
    return partial, seq_state, {}


def mlp_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    xn = _n2(p, x, sctx.cfg)
    return mlp_lib.mlp_partial(p["mlp"], xn, sctx.cfg.mlp_type), seq_state, {}


def moe_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    xn = _n2(p, x, sctx.cfg)
    partial, aux = moe_lib.moe_partial(p["moe"], xn, sctx.cfg.moe,
                                       tp=sctx.tp,
                                       expert_offset=sctx.expert_offset)
    return partial, seq_state, {"moe_aux": aux}


def _post_norm(p, key: str, cfg: ModelConfig):
    """The afmoe norm after a sublayer, as a function of its reduced
    output."""
    return lambda out: norm(p[key], out, cfg.norm_type, cfg.rms_eps)


def afmoe_attn_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None,
                     full: bool = False):
    """afmoe attention: the input norm, GQA with per-head q/k norm and the
    output gate (``attn.wg``), then ``post_attn_norm`` on the reduced
    output.  A sliding layer attends the model's ``sliding_window`` with
    RoPE; a ``full`` one every earlier position with no rotary embedding
    (NoPE)."""
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    window, rope = (0, False) if full else (sctx.window, True)
    post = _post_norm(p, "post_attn_norm", cfg)
    if sctx.mode == "decode":
        partial, kv_new = _decode_attn(p["attn"], xn, sctx, cache,
                                       window=window, rope=rope)
        return partial, seq_state, {"kv": kv_new, "post": post}
    if sctx.mode == "encode":
        raise NotImplementedError("afmoe blocks are decoder layers")
    partial, kv_new = _prefill_attn(p["attn"], xn, seq_state, cache, sctx,
                                    start_pos, x.shape[0], window=window,
                                    rope=rope)
    return partial, _grow_kv(seq_state, kv_new), {"kv": kv_new,
                                                  "post": post}


def afmoe_full_attn_stage(p, x, start_pos, seq_state, sctx: StageCtx,
                          cache=None):
    return afmoe_attn_stage(p, x, start_pos, seq_state, sctx, cache,
                            full=True)


def afmoe_mlp_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    """afmoe's dense FFN (the leading layers): ``mlp_stage`` with
    ``post_mlp_norm`` on the reduced output."""
    out, seq_state, _ = mlp_stage(p, x, start_pos, seq_state, sctx, cache)
    return out, seq_state, {"post": _post_norm(p, "post_mlp_norm", sctx.cfg)}


def afmoe_moe_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    """afmoe's MoE FFN: the dropless sigmoid-routed layer (a decode step
    takes the decode kernels), ``post_mlp_norm`` on the reduced output."""
    cfg = sctx.cfg
    xn = _n2(p, x, cfg)
    partial, aux = moe_lib.moe_partial(
        p["moe"], xn, cfg.moe, tp=sctx.tp, expert_offset=sctx.expert_offset,
        decode=sctx.mode == "decode", hits=sctx.moe_hits)
    return partial, seq_state, {"moe_aux": aux,
                                "post": _post_norm(p, "post_mlp_norm", cfg)}


def _carry(seq_state, cache, key):
    """A recurrent stage's incoming state: the call's previous chunk's, else
    the cache's (a decode step, a resumed grant), else None (zero)."""
    if seq_state is None and cache is not None and key in cache:
        return cache[key]
    return seq_state


def hybrid_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    """hymba: attention and mamba heads side by side on the one pre-norm
    input; their unreduced partials ADD, so the block still ends in ONE
    all-reduce.  seq_state: (the call's kv prefix, the SSM state)."""
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    kv_state, ssm_state = seq_state if seq_state is not None else (None,
                                                                   None)
    if sctx.mode == "decode":
        a_part, kv_new = _decode_attn(p["attn"], xn, sctx, cache)
        s_part, ssm_new = ssm_lib.ssm_decode_partial(p["ssm"], xn, cfg.ssm,
                                                     cache["ssm"])
        return a_part + s_part, seq_state, {"kv": kv_new, "ssm": ssm_new}
    ssm_state = _carry(ssm_state, cache, "ssm")
    a_part, kv_new = _prefill_attn(p["attn"], xn, kv_state, cache, sctx,
                                   start_pos, x.shape[0])
    s_part, ssm_new = ssm_lib.ssm_partial(p["ssm"], xn, cfg.ssm, ssm_state)
    return a_part + s_part, (_grow_kv(kv_state, kv_new), ssm_new), \
        {"kv": kv_new, "ssm": ssm_new}


def mlstm_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    out, state = xlstm_lib.mlstm_partial(p["mlstm"], xn, cfg,
                                         _carry(seq_state, cache, "mlstm"))
    return out, state, {"mlstm": state}


def slstm_stage(p, x, start_pos, seq_state, sctx: StageCtx, cache=None):
    cfg = sctx.cfg
    xn = _n1(p, x, cfg)
    out, state = xlstm_lib.slstm_forward(p["slstm"], xn, cfg,
                                         _carry(seq_state, cache, "slstm"))
    return out, state, {"slstm": state}


# kind -> ((stage_fn, reduces), ...); the sLSTM's replicated weights give a
# whole output: no collective
BLOCK_STAGES = {
    BLOCK_ATTN_MLP: ((attn_stage, True), (mlp_stage, True)),
    BLOCK_ATTN_MOE: ((attn_stage, True), (moe_stage, True)),
    BLOCK_HYBRID: ((hybrid_stage, True), (mlp_stage, True)),
    BLOCK_MLSTM: ((mlstm_stage, True),),
    BLOCK_SLSTM: ((slstm_stage, False),),
    BLOCK_DEC: ((attn_stage, True), (cross_attn_stage, True),
                (mlp_stage, True)),
    BLOCK_AF_SWA_MLP: ((afmoe_attn_stage, True), (afmoe_mlp_stage, True)),
    BLOCK_AF_FULL_MLP: ((afmoe_full_attn_stage, True),
                        (afmoe_mlp_stage, True)),
    BLOCK_AF_SWA_MOE: ((afmoe_attn_stage, True), (afmoe_moe_stage, True)),
    BLOCK_AF_FULL_MOE: ((afmoe_full_attn_stage, True),
                        (afmoe_moe_stage, True)),
}

# the per-slot recurrent states a block kind carries, by cache key
STATE_KEYS = ("ssm", "mlstm", "slstm")


def pattern_all_reduces(pattern) -> bool:
    """True when every stage of every block kind in ``pattern`` ends in a TP
    all-reduce: the precondition of the ladder-residual wiring
    (core/iso.run_stack_decode_ladder), since a stage without a collective
    has nothing to lag behind the next stage's compute (the sLSTM), and the
    one-stage lag would change the function for no overlap."""
    return all(r for kind in pattern for _, r in BLOCK_STAGES[kind])
