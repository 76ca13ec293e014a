"""Decoder-stack model driver (port of ``repro/models/decoder.py`` for the
dense, MoE, hybrid (hymba), xLSTM and VLM families and for whisper's encoder
and decoder stacks, ``models/whisper.py``).  A VLM prompt is its patch
embeddings (the stub vision encoder's output) followed by its text.

Forward code is written in the local-shard view: under tensor parallelism
each rank holds its shard of every sharded leaf (``SHARD_AXIS``) and the
collectives of ``AxisCtx`` join the ranks; at tp=1 that is the whole model.
Parameters are plain dicts of tensors: ``{"embed": {"table", "head"},
"final_norm": {"scale"}, "periods": (per pattern position, a list of
per-period layer dicts)}`` — the reference's ``(P, ...)``-stacked leaves
unstacked into one dict per layer.  LayerNorm configs add a ``bias`` to
every norm; a ``dec_block`` layer adds ``cross`` (the cross-attention's
projections) and ``norm_cross``; an ``attn_moe`` layer has ``moe``
(layers/moe.init_moe: ``router``, expert-stacked ``w_up``/``w_gate``/
``w_down``, an optional ``shared`` expert) where a dense one has ``mlp``; a
``hybrid`` layer has ``attn``, ``ssm`` (layers/ssm.init_ssm) and ``mlp``;
an ``mlstm`` or ``slstm`` layer has ``norm1`` and ``mlstm`` or ``slstm``
(layers/xlstm.py) only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import AFMOE_KINDS, BLOCK_ATTN_MLP, BLOCK_ATTN_MOE, \
    BLOCK_DEC, BLOCK_HYBRID, BLOCK_MLSTM, BLOCK_SLSTM, MOE_KINDS, ISOConfig, \
    ModelConfig, SigmoidMoEConfig, padded_vocab
from repro_torch.core.chunking import split_chunks
from repro_torch.core.iso import run_stack_decode, run_stack_prefill
from repro_torch.core.overlap import AxisCtx, psum_now
from repro_torch.device import generator
from repro_torch.layers import embeddings as emb_lib
from repro_torch.layers.heads import expand_heads, head_layout
from repro_torch.layers import ssm as ssm_lib
from repro_torch.layers import xlstm as xlstm_lib
from repro_torch.layers.moe import init_moe
from repro_torch.layers.norms import init_norm, norm
from repro_torch.layers.rope import sinusoid_angles, sinusoidal_embedding
from repro_torch.models.blocks import STATE_KEYS, StageCtx


# family -> the block kinds the port serves in it
FAMILY_KINDS = {"dense": (BLOCK_ATTN_MLP,),
                "moe": (BLOCK_ATTN_MOE,),
                "hybrid": (BLOCK_HYBRID,),
                "ssm": (BLOCK_MLSTM, BLOCK_SLSTM),
                "audio": (BLOCK_ATTN_MLP, BLOCK_DEC),
                "vlm": (BLOCK_ATTN_MLP,),
                "afmoe": AFMOE_KINDS}


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense and VLM ``attn_mlp`` and MoE ``attn_moe``
    stacks, standard- or ladder-wired, hymba's ``hybrid`` and xLSTM's
    ``mlstm`` / ``slstm`` stacks, and whisper's encoder (``attn_mlp``) and
    decoder (``dec_block``) stacks, the reference's whole registry, and
    the afmoe family's stacks (``AFMOE_KINDS``, standard-wired); any other
    family or block kind raises."""
    kinds = FAMILY_KINDS.get(cfg.family, ())
    if not kinds or any(k not in kinds for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / blocks {cfg.block_pattern}"
            f" are not ported")
    if cfg.residual_wiring not in ("standard", "ladder"):
        raise ValueError(f"{cfg.name}: unknown residual wiring "
                         f"{cfg.residual_wiring!r}")
    if cfg.family == "afmoe" and (
            cfg.residual_wiring != "standard"
            or not isinstance(cfg.moe, SigmoidMoEConfig)):
        raise ValueError(f"{cfg.name}: an afmoe stack is standard-wired with "
                         f"a dropless (SigmoidMoEConfig) router")


# ---------------------------------------------------------------------------
# tensor-parallel sharding (the rules of the reference's
# models/decoder._leaf_spec): a leaf's name, its parent and its rank -> the
# axis split over the tp ranks, or None (replicated: norms, qk-norm scales,
# the MoE router, the SSM's w_b/w_c, the mLSTM's q/k and gates, the biases,
# and every leaf under ``slstm``)
# ---------------------------------------------------------------------------

SHARD_AXIS = {
    "table": 0, "head": 0,                   # vocab-split
    "wq": 1, "wk": 1, "wv": 1,               # (D, H, hd): column-split heads
    "wg": 1,                                 # afmoe's output gate, as wq
    "wo": 0,                                 # (H, hd, D): row-split
    "w_up": 1, "w_gate": 1,                  # (D, F): column-split
    "w_down": 0,                             # (F, D): row-split
    "w_x": 1, "w_z": 1, "w_dt": 1,           # SSM (D, inner): column-split
    "conv_w": 1,                             # (width, inner)
    "dt_bias": 0, "d_skip": 0, "a_log": 0,   # along inner
    "w_v": 2, "w_og": 2,                     # mLSTM (D, H, hd): the v dim
}
EXPERT_AXIS = 0                              # (E, D, F) / (E, F, D)


def shard_axis(name: str, parent: str, ndim: int) -> Optional[int]:
    """The axis of leaf ``name`` (under ``parent``, of ``ndim`` dims) split
    over the tp ranks, or None when it is replicated."""
    if parent == "slstm":                    # replicated, w_z included
        return None
    if name in ("w_up", "w_gate", "w_down") and ndim == 3:
        return EXPERT_AXIS                   # MoE expert-stacked
    if name == "w_out":                      # mLSTM (H, hd_loc, D): dim 1;
        return 1 if ndim == 3 else 0         # SSM (inner_loc, D): rows
    return SHARD_AXIS.get(name)


def shard_leaf(name: str, t: torch.Tensor, rank: int, tp: int,
               parent: str = "") -> torch.Tensor:
    """Rank ``rank``'s shard of leaf ``name`` under ``parent`` (a copy, so
    the full tensor can be freed); replicated leaves come back as they
    are."""
    axis = shard_axis(name, parent, t.ndim)
    if axis is None or tp == 1:
        return t
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"leaf {name} {tuple(t.shape)}: axis {axis} is not "
                         f"divisible by tp={tp}; build the params at tp={tp}")
    return t.narrow(axis, rank * (n // tp), n // tp).clone()


def _shard_tree(tree, rank: int, tp: int, name: str = "", parent: str = ""):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, rank, tp, k, name) for k, v in tree.items()}
    return shard_leaf(name, tree, rank, tp, parent)


def shard_params(params: Dict, rank: int, tp: int) -> Dict:
    """Rank ``rank``'s local view of port params built at tp=``tp`` (head
    slots, vocab and the SSM's inner dim padded for that degree)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    out = {k: _shard_tree(v, rank, tp) for k, v in params.items()
           if k != "periods"}
    out["periods"] = tuple([_shard_tree(layer, rank, tp) for layer in pos]
                           for pos in params["periods"])
    return out


def pattern_periods(cfg: ModelConfig) -> int:
    n = len(cfg.block_pattern)
    assert cfg.num_layers % n == 0, (cfg.num_layers, cfg.block_pattern)
    return cfg.num_layers // n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def _init_attention(gen, cfg: ModelConfig, layout, dtype, device,
                    cross: bool = False, gate: bool = False) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = 0.02
    so = s / (2 * cfg.num_layers) ** 0.5

    def heads(shape, std, mapping, axis):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std
        return expand_heads(w, mapping, axis).to(dtype)

    attn = {
        "wq": heads((d, layout.hq, hd), s, layout.q_map, 1),
        "wk": heads((d, layout.hkv, hd), s, layout.kv_map, 1),
        "wv": heads((d, layout.hkv, hd), s, layout.kv_map, 1),
        "wo": heads((layout.hq, hd, d), so, layout.q_map, 0),
    }
    if cfg.qk_norm and not cross:
        attn["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        attn["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    if gate:
        attn["wg"] = heads((d, layout.hq, hd), s, layout.q_map, 1)
    return attn


def _init_layer(gen, cfg: ModelConfig, kind: str, layout, dtype,
                device, tp: int) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    s = 0.02
    so = s / (2 * cfg.num_layers) ** 0.5
    p = {"norm1": init_norm(d, device, cfg.norm_type)}
    if kind == BLOCK_MLSTM:
        p["mlstm"] = xlstm_lib.init_mlstm(gen, cfg, dtype, device)
        return p
    if kind == BLOCK_SLSTM:
        p["slstm"] = xlstm_lib.init_slstm(gen, cfg, dtype, device)
        return p
    afmoe = kind in AFMOE_KINDS
    p["attn"] = _init_attention(gen, cfg, layout, dtype, device, gate=afmoe)
    p["norm2"] = init_norm(d, device, cfg.norm_type)
    if afmoe:
        p["post_attn_norm"] = init_norm(d, device, cfg.norm_type)
        p["post_mlp_norm"] = init_norm(d, device, cfg.norm_type)
    if kind in MOE_KINDS:
        p["moe"] = init_moe(gen, d, cfg.moe, tp, cfg.num_layers, dtype,
                            device)
        return p
    if kind == BLOCK_HYBRID:
        p["ssm"] = ssm_lib.init_ssm(gen, d, cfg.ssm, tp, cfg.num_layers,
                                    dtype, device)
    mlp = {"w_up": _normal(gen, (d, ff), s, dtype, device)}
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = _normal(gen, (d, ff), s, dtype, device)
    mlp["w_down"] = _normal(gen, (ff, d), so, dtype, device)
    p["mlp"] = mlp
    if kind == BLOCK_DEC:
        p["cross"] = _init_attention(gen, cfg, layout, dtype, device,
                                     cross=True)
        p["norm_cross"] = init_norm(d, device, cfg.norm_type)
    return p


def init_decoder_params(seed: int, cfg: ModelConfig, tp: int = 1,
                        dtype=torch.bfloat16, device: torch.device = None,
                        rank: Optional[int] = None) -> Dict:
    """Random weights from ``seed`` with the reference's distributions
    (normal x 0.02; ``wo``, ``w_down`` and the recurrent blocks' out
    projections x 0.02/sqrt(2L); norms at one, LayerNorm biases at zero;
    the recurrent blocks' fp32 leaves as layers/ssm.py and
    layers/xlstm.py make them), made on ``device``.  The bits differ from the
    reference's: JAX's PRNG is not re-implemented (``bridge.py`` imports the
    reference's own weights).

    With ``rank`` given, returns that rank's shard of the tp=``tp`` model,
    equal to ``shard_params`` of the whole: every leaf is drawn in full from
    the same stream and cut at once, so no more than one layer is ever held
    whole."""
    check_supported(cfg)
    gen = generator(device, seed)
    layout = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), tp)
    v = padded_vocab(cfg, tp)
    cut = (lambda tree: _shard_tree(tree, rank, tp)) if rank is not None \
        else (lambda tree: tree)
    embed = {"table": _normal(gen, (v, cfg.d_model), 0.02, dtype, device)}
    if not cfg.tie_embeddings:
        embed["head"] = _normal(gen, (v, cfg.d_model), 0.02, dtype, device)
    embed = cut(embed)
    periods = tuple([cut(_init_layer(gen, cfg, kind, layout, dtype, device,
                                     tp))
                     for _ in range(pattern_periods(cfg))]
                    for kind in cfg.block_pattern)
    return {"embed": embed,
            "final_norm": init_norm(cfg.d_model, device, cfg.norm_type),
            "periods": periods}


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

def _stage_ctx(cfg: ModelConfig, ctx: AxisCtx, mode: str,
               lengths=None) -> StageCtx:
    layout = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), ctx.tp)
    expert_offset = 0
    if cfg.moe is not None:
        e_loc = cfg.moe.padded_experts(ctx.tp) // ctx.tp
        expert_offset = ctx.axis_index() * e_loc
    return StageCtx(cfg=cfg, group_eff=layout.group_eff, tp=ctx.tp,
                    expert_offset=expert_offset, mode=mode,
                    window=cfg.sliding_window, lengths=lengths)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: AxisCtx) -> torch.Tensor:
    """Token embeddings, plus the sinusoid table's rows 0..S-1 (cast to the
    embedding dtype) for a sinusoidal-position config, times the config's
    ``embed_scale`` (in fp32)."""
    v_loc = params["embed"]["table"].shape[0]
    e = emb_lib.embed_partial(params["embed"], tokens,
                              ctx.axis_index() * v_loc)
    e = psum_now(e, ctx)
    if cfg.pos_type == "sinusoidal":
        e = e + sinusoidal_embedding(tokens.shape[1], cfg.d_model,
                                     device=e.device).to(e.dtype)[None]
    scale = getattr(cfg, "embed_scale", 1.0)   # AfmoeModelConfig's
    if scale != 1.0:
        e = (e.float() * scale).to(e.dtype)
    return e


def _final(params, x, cfg):
    return norm(params["final_norm"], x, cfg.norm_type, cfg.rms_eps)


# ---------------------------------------------------------------------------
# prefill (ISO lives here)
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig, *,
            tokens: torch.Tensor = None, embeds: torch.Tensor = None,
            extra_embeds: torch.Tensor = None,
            logits_mode: str = "all", return_cache: bool = False,
            cache_len: int = 0, remat: bool = False, layer_statics=None,
            mode: str = "prefill", prefix_caches=None, pos_offset=0,
            block_tables=None, prefix_lens=None, valid_len=None,
            return_extras: bool = False, moe_hits=None) -> Dict[str, Any]:
    """Run the stack over a prompt, or one resumed slice of it, with the ISO
    schedule.  tokens: (B, S) integer, or embeds: (B, S, D) precomputed (the
    whisper encoder's frames).  ``extra_embeds`` (B, S0, D): continuous
    tokens prepended to the text (a VLM's patches), cast to the embedding
    dtype; the ISO split then sees S0 + S positions.  ``remat``: recompute
    each pattern period in the backward pass instead of keeping its
    activations (training; ``core/iso.run_stack_prefill``).
    ``mode="encode"`` runs bidirectional
    attention (the whisper encoder).  ``logits_mode``: ``all`` rows,
    the ``last`` row, or ``none``.

    ``layer_statics``: per-position dicts of period-stacked leaves every
    chunk reads (whisper's cross K/V, ``cross_k``/``cross_v`` (P, B, F, Hkv,
    hd)).  ``return_cache``: the call's KV as dense decode caches of
    ``cache_len`` slots (default S), ``{k, v, pos}`` per attention position
    (``_build_caches``).

    Paged resumed prefill: ``prefix_caches`` is a per-position tuple of
    dicts with the page pools (``k_pages``/``v_pages``, (P, N+1, ps, Hkv,
    hd)); ``block_tables`` (B, MB) and ``prefix_lens`` (B,) let attention
    read the prefix in place through the paged flash-prefill kernel, and
    ``pos_offset`` is the absolute position of this call's first token.
    ``valid_len`` marks how many of the call's tokens are real: the
    bucket-padded tail beyond it is masked out of attention.  The call's own
    ISO chunking happens here, so overlap applies within a resumed slice as in
    a monolithic prefill.  A ladder-wired config runs single-chunk, always:
    the lagged residual supplies the overlap, and an ISO interleave would
    restore the standard wiring per chunk.  ``moe_hits`` (0-d int64 on the
    device): a dropless MoE layer adds the local experts it reached."""
    check_supported(cfg)
    if embeds is None:
        embeds = embed_tokens(params, tokens, cfg, ctx)
        if cfg.pos_type == "sinusoidal" and not (
                isinstance(pos_offset, int) and pos_offset == 0):
            raise NotImplementedError(
                "resumed prefill with sinusoidal positions (traced offset)")
    if extra_embeds is not None:
        embeds = torch.cat([extra_embeds.to(embeds.dtype), embeds], dim=1)
    if layer_statics is not None and prefix_caches is not None:
        raise ValueError("layer_statics and prefix_caches both given")
    B, S, D = embeds.shape
    ladder = cfg.residual_wiring == "ladder"
    lengths = [S] if ladder else split_chunks(S, iso, cfg, tp=ctx.tp)
    starts, acc = [], 0
    for l in lengths:
        starts.append(acc)
        acc += l
    x_chunks = [embeds[:, s0:s0 + l] for s0, l in zip(starts, lengths)]

    sctx = _stage_ctx(cfg, ctx, mode, lengths=prefix_lens)
    sctx.pos_offset = pos_offset
    sctx.block_tables = block_tables
    sctx.valid_len = valid_len
    sctx.moe_hits = moe_hits
    xs_final, extras = run_stack_prefill(
        params["periods"], cfg.block_pattern, x_chunks, tuple(starts), sctx,
        ctx, layer_caches=layer_statics if prefix_caches is None
        else prefix_caches, ladder=ladder, remat=remat)
    x = torch.cat(xs_final, dim=1) if len(xs_final) > 1 else xs_final[0]
    x = _final(params, x, cfg)

    out: Dict[str, Any] = {"hidden": x, "num_chunks": len(lengths),
                           "chunk_lengths": lengths}
    if logits_mode == "all":
        out["logits_local"] = emb_lib.lm_head_local(params["embed"], x)
    elif logits_mode == "last":
        out["logits_local"] = emb_lib.lm_head_local(params["embed"],
                                                    x[:, -1:, :])
    elif logits_mode != "none":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    # the MoE load-balance aux, summed over chunks, layers and positions
    # (0.0 for a stack without MoE, as the reference)
    aux = 0.0
    for ex in extras:
        if "moe_aux" in ex:
            aux = aux + torch.sum(ex["moe_aux"])
    out["moe_aux"] = aux
    if return_cache:
        out["caches"] = _build_caches(extras, cfg, B, S, cache_len or S)
    if return_extras:
        # per position, kv_k/kv_v of the S new tokens stacked over periods
        # (P, B, S, Hkv, hd): the paged engine scatters these into pages
        out["extras"] = extras
    return out


def _build_caches(extras, cfg: ModelConfig, B: int, S: int, cache_len: int):
    """Per-position prefill extras -> dense decode caches: ``k``/``v`` (P,
    B, L, Hkv, hd) and ``pos`` (P, B, L) int32 (-1 = empty), L the cache
    length (the window for a sliding-window config), the last L tokens at
    slot ``position % L``; and a recurrent position's final state
    (``ssm``/``mlstm``/``slstm``, period-stacked) as it is."""
    caches = []
    for ex in extras:
        c: Dict[str, Any] = {}
        if "kv_k" in ex:
            k, v = ex["kv_k"], ex["kv_v"]              # (P, B, S, H, hd)
            eff_len = min(cache_len, cfg.sliding_window) \
                if cfg.sliding_window else cache_len
            ck = torch.zeros((k.shape[0], B, eff_len) + k.shape[3:],
                             dtype=k.dtype, device=k.device)
            cv = torch.zeros_like(ck)
            cpos = torch.full((k.shape[0], B, eff_len), -1,
                              dtype=torch.int32, device=k.device)
            n_keep = min(S, eff_len)
            pos_vals = torch.arange(S - n_keep, S, dtype=torch.int32,
                                    device=k.device)
            slots = (pos_vals % eff_len).long()
            ck[:, :, slots] = k[:, :, S - n_keep:]
            cv[:, :, slots] = v[:, :, S - n_keep:]
            cpos[:, :, slots] = pos_vals
            c.update(k=ck, v=cv, pos=cpos)
        for sk in STATE_KEYS:
            if sk in ex:
                c[sk] = ex[sk]
        caches.append(c)
    return tuple(caches)


def init_state_caches(cfg: ModelConfig, batch: int, tp: int = 1,
                      dtype=torch.bfloat16, device=None,
                      local: bool = False):
    """Zero recurrent states per pattern position, period-stacked: a
    ``hybrid`` position's ``ssm`` (``SSMState``: conv (P, batch, width-1,
    inner) in ``dtype``, h (P, batch, inner, N) fp32), an ``mlstm``'s
    (``MLSTMState``: c (P, batch, H, hd, hd), n, m at -1e30, fp32) and an
    ``slstm``'s (``SLSTMState``, (P, batch, D) each, n at 1, fp32); other
    positions get ``{}``.  GLOBAL shapes (the SSM inner dim padded for
    ``tp``), or with ``local`` one rank's: inner and the mLSTM's v dim
    divided by ``tp``, as the reference's ``cache_specs`` shard them."""
    periods = pattern_periods(cfg)
    split = tp if local else 1

    def stacked(state):
        return type(state)(*(t.unsqueeze(0).repeat(
            (periods,) + (1,) * t.ndim) for t in state))

    out = []
    for kind in cfg.block_pattern:
        c: Dict[str, Any] = {}
        if kind == BLOCK_HYBRID:
            inner = ssm_lib.inner_dim(cfg.d_model, cfg.ssm, tp) // split
            c["ssm"] = stacked(ssm_lib.init_ssm_state(batch, inner, cfg.ssm,
                                                      dtype, device))
        elif kind == BLOCK_MLSTM:
            hd = cfg.d_model // cfg.num_heads
            c["mlstm"] = stacked(xlstm_lib.init_mlstm_state(
                batch, cfg.num_heads, hd, hd // split, device))
        elif kind == BLOCK_SLSTM:
            c["slstm"] = stacked(xlstm_lib.init_slstm_state(
                batch, cfg.d_model, device))
        out.append(c)
    return tuple(out)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, tp: int = 1,
                dtype=torch.bfloat16, device=None, local: bool = False):
    """Empty dense decode caches at the GLOBAL padded kv head count: per
    attention position ``k``/``v`` (P, batch, L, Hkv, hd) zeros and ``pos``
    (P, batch, L) int32 at -1, L = ``cache_len`` (the window for a
    sliding-window config), and beside them each position's zero recurrent
    state (``init_state_caches``).  ``local``: one tp rank's shard, Hkv /
    tp heads and the states as ``init_state_caches(local=True)`` makes
    them (the reference's ``cache_specs`` split)."""
    if cfg.family == "afmoe":
        raise NotImplementedError(
            f"{cfg.name}: dense ring caches take one window for every layer;"
            f" the afmoe stack's layers differ, and PagedEngine serves it")
    periods = pattern_periods(cfg)
    hkv = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), tp).hkv_eff
    hkv //= tp if local else 1
    eff_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shape = (periods, batch, eff_len, hkv, cfg.resolved_head_dim)
    caches = init_state_caches(cfg, batch, tp, dtype, device, local=local)
    for kind, c in zip(cfg.block_pattern, caches):
        if kind not in (BLOCK_MLSTM, BLOCK_SLSTM):
            c.update(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device),
                     pos=torch.full(shape[:3], -1, dtype=torch.int32,
                                    device=device))
    return caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, ctx: AxisCtx, tokens, caches,
                lengths, block_tables=None, decode_mask=None,
                kv_splits: int = 1, schedule: Optional[str] = None,
                moe_hits=None):
    """tokens: (B, K) integer, K=1 plain decode or a K-token verify window
    (token qi at position ``lengths[b] + qi``); lengths: (B,) tokens already
    processed.

    Dense decode (the dense ``Engine``): ``caches`` carry ``k``/``v``/``pos``
    (``init_caches``) per attention position, and whisper's decoder also
    ``cross_k``/``cross_v``; the window's KV is inserted at ``lengths %
    ring`` IN PLACE.

    Paged decode: ``caches`` carry ``k_pages``/``v_pages`` per attention
    position and ``block_tables`` (B, MB) maps positions to pages;
    ``decode_mask`` (B,) marks the slots really decoding (others scatter to
    the scratch page).  The window's KV is scattered into the pools IN PLACE.
    ``kv_splits`` runs each paged attention's page walk as that many split-KV
    spans.  ``schedule`` is the collective schedule of core/iso.py
    (``sequential``, ``batch_split``, ``cross_block``, ``ladder`` or
    ``ladder_seq``; default sequential).  A ladder-wired config always runs
    the ladder decode stack (the wiring is part of the model function),
    deferred unless the schedule is ``sequential`` or ``ladder_seq``; forcing
    ``ladder`` on a standard-wired config runs the REWIRED function (the
    overlap probe's timing proxy, never for serving).  ``moe_hits`` as
    ``prefill``'s.  Returns (logits_local (B, K, V_loc), caches)."""
    check_supported(cfg)
    schedule = schedule or "sequential"
    if cfg.residual_wiring == "ladder" and \
            schedule not in ("ladder", "ladder_seq"):
        schedule = "ladder_seq" if schedule == "sequential" else "ladder"
    x = embed_tokens(params, tokens, cfg, ctx)
    if cfg.pos_type == "sinusoidal":
        # embed_tokens added the sinusoids of positions 0..K-1: trade them
        # for each request's own, in fp32
        K = tokens.shape[1]
        base = sinusoidal_embedding(K, cfg.d_model, device=x.device)[None]
        pos = lengths.to(device=x.device, dtype=torch.int32)[:, None] + \
            torch.arange(K, dtype=torch.int32, device=x.device)[None]
        x = (x.float() - base + sinusoid_angles(pos, cfg.d_model)).to(x.dtype)
    sctx = _stage_ctx(cfg, ctx, "decode", lengths=lengths)
    sctx.block_tables = block_tables
    sctx.decode_mask = decode_mask
    sctx.kv_splits = kv_splits
    sctx.moe_hits = moe_hits
    x, caches = run_stack_decode(params["periods"], cfg.block_pattern, x,
                                 caches, sctx, ctx, schedule=schedule)
    x = _final(params, x, cfg)
    return emb_lib.lm_head_local(params["embed"], x), caches
