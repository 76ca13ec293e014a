"""Decoder-stack model driver, dense family (port of the dense subset of
``repro/models/decoder.py``).

Forward code is written in the local-shard view: under tensor parallelism
each rank holds its shard of every sharded leaf (``SHARD_AXIS``) and the
collectives of ``AxisCtx`` join the ranks; at tp=1 that is the whole model.
Parameters are plain dicts of tensors: ``{"embed": {"table", "head"},
"final_norm": {"scale"}, "periods": (per pattern position, a list of
per-period layer dicts)}`` — the reference's ``(P, ...)``-stacked leaves
unstacked into one dict per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import BLOCK_ATTN_MLP, ISOConfig, ModelConfig, \
    padded_vocab
from repro_torch.core.chunking import split_chunks
from repro_torch.core.iso import run_stack_decode, run_stack_prefill
from repro_torch.core.overlap import AxisCtx, psum_now
from repro_torch.layers import embeddings as emb_lib
from repro_torch.layers.heads import expand_heads, head_layout
from repro_torch.layers.norms import init_norm, norm
from repro_torch.models.blocks import StageCtx


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense ``attn_mlp`` stacks, standard- or
    ladder-wired; anything else raises, naming its ROADMAP item."""
    if cfg.family not in ("dense",) or \
            any(k != BLOCK_ATTN_MLP for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / blocks {cfg.block_pattern}"
            f" are not ported (ROADMAP queue A item 10)")
    if cfg.residual_wiring not in ("standard", "ladder"):
        raise ValueError(f"{cfg.name}: unknown residual wiring "
                         f"{cfg.residual_wiring!r}")


# ---------------------------------------------------------------------------
# tensor-parallel sharding (the dense rules of the reference's
# models/decoder._leaf_spec): leaf name -> the axis split over the tp ranks;
# leaves not named here (norms, qk-norm scales) are replicated
# ---------------------------------------------------------------------------

SHARD_AXIS = {
    "table": 0, "head": 0,                   # vocab-split
    "wq": 1, "wk": 1, "wv": 1,               # (D, H, hd): column-split heads
    "wo": 0,                                 # (H, hd, D): row-split
    "w_up": 1, "w_gate": 1,                  # (D, F): column-split
    "w_down": 0,                             # (F, D): row-split
}


def shard_leaf(name: str, t: torch.Tensor, rank: int, tp: int
               ) -> torch.Tensor:
    """Rank ``rank``'s shard of leaf ``name`` (a copy, so the full tensor can
    be freed); replicated leaves come back as they are."""
    axis = SHARD_AXIS.get(name)
    if axis is None or tp == 1:
        return t
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"leaf {name} {tuple(t.shape)}: axis {axis} is not "
                         f"divisible by tp={tp}; build the params at tp={tp}")
    return t.narrow(axis, rank * (n // tp), n // tp).clone()


def _shard_tree(tree, rank: int, tp: int, name: str = ""):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, rank, tp, k) for k, v in tree.items()}
    return shard_leaf(name, tree, rank, tp)


def shard_params(params: Dict, rank: int, tp: int) -> Dict:
    """Rank ``rank``'s local view of port params built at tp=``tp`` (head
    slots and vocab padded for that degree)."""
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


def _init_layer(gen, cfg: ModelConfig, layout, dtype, device) -> Dict:
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
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
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        attn["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    mlp = {"w_up": _normal(gen, (d, ff), s, dtype, device),
           "w_gate": _normal(gen, (d, ff), s, dtype, device),
           "w_down": _normal(gen, (ff, d), so, dtype, device)}
    return {"norm1": init_norm(d, device), "attn": attn,
            "norm2": init_norm(d, device), "mlp": mlp}


def init_decoder_params(seed: int, cfg: ModelConfig, tp: int = 1,
                        dtype=torch.bfloat16, device: torch.device = None,
                        rank: Optional[int] = None) -> Dict:
    """Random weights from ``seed`` with the reference's distributions
    (normal x 0.02; ``wo`` and ``w_down`` x 0.02/sqrt(2L); norms at one), made
    on ``device``.  The bits differ from the reference's: JAX's PRNG is not
    re-implemented (``bridge.py`` imports the reference's own weights).

    With ``rank`` given, returns that rank's shard of the tp=``tp`` model,
    equal to ``shard_params`` of the whole: every leaf is drawn in full from
    the same stream and cut at once, so no more than one layer is ever held
    whole."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), tp)
    v = padded_vocab(cfg, tp)
    cut = (lambda tree: _shard_tree(tree, rank, tp)) if rank is not None \
        else (lambda tree: tree)
    embed = {"table": _normal(gen, (v, cfg.d_model), 0.02, dtype, device)}
    if not cfg.tie_embeddings:
        embed["head"] = _normal(gen, (v, cfg.d_model), 0.02, dtype, device)
    embed = cut(embed)
    periods = tuple([cut(_init_layer(gen, cfg, layout, dtype, device))
                     for _ in range(pattern_periods(cfg))]
                    for _ in cfg.block_pattern)
    return {"embed": embed, "final_norm": init_norm(cfg.d_model, device),
            "periods": periods}


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

def _stage_ctx(cfg: ModelConfig, ctx: AxisCtx, mode: str,
               lengths=None) -> StageCtx:
    layout = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), ctx.tp)
    return StageCtx(cfg=cfg, group_eff=layout.group_eff, mode=mode,
                    window=cfg.sliding_window, lengths=lengths)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: AxisCtx) -> torch.Tensor:
    v_loc = params["embed"]["table"].shape[0]
    e = emb_lib.embed_partial(params["embed"], tokens,
                              ctx.axis_index() * v_loc)
    return psum_now(e, ctx)


def _final(params, x, cfg):
    return norm(params["final_norm"], x, cfg.norm_type, cfg.rms_eps)


# ---------------------------------------------------------------------------
# prefill (ISO lives here)
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig, *,
            tokens: torch.Tensor, logits_mode: str = "all",
            prefix_caches=None, pos_offset=0, block_tables=None,
            prefix_lens=None, valid_len=None,
            return_extras: bool = False) -> Dict[str, Any]:
    """Run the stack over a prompt, or one resumed slice of it, with the ISO
    schedule.  tokens: (B, S) integer.

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
    restore the standard wiring per chunk."""
    check_supported(cfg)
    embeds = embed_tokens(params, tokens, cfg, ctx)
    B, S, D = embeds.shape
    ladder = cfg.residual_wiring == "ladder"
    lengths = [S] if ladder else split_chunks(S, iso, cfg, tp=ctx.tp)
    starts, acc = [], 0
    for l in lengths:
        starts.append(acc)
        acc += l
    x_chunks = [embeds[:, s0:s0 + l] for s0, l in zip(starts, lengths)]

    sctx = _stage_ctx(cfg, ctx, "prefill", lengths=prefix_lens)
    sctx.pos_offset = pos_offset
    sctx.block_tables = block_tables
    sctx.valid_len = valid_len
    xs_final, extras = run_stack_prefill(
        params["periods"], cfg.block_pattern, x_chunks, tuple(starts), sctx,
        ctx, layer_caches=prefix_caches, ladder=ladder)
    x = torch.cat(xs_final, dim=1) if len(xs_final) > 1 else xs_final[0]
    x = _final(params, x, cfg)

    out: Dict[str, Any] = {"hidden": x, "num_chunks": len(lengths),
                           "chunk_lengths": lengths}
    if logits_mode == "all":
        out["logits_local"] = emb_lib.lm_head_local(params["embed"], x)
    if return_extras:
        # per position, kv_k/kv_v of the S new tokens stacked over periods
        # (P, B, S, Hkv, hd): the paged engine scatters these into pages
        out["extras"] = extras
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, ctx: AxisCtx, tokens, caches,
                lengths, block_tables=None, decode_mask=None,
                kv_splits: int = 1, schedule: Optional[str] = None):
    """tokens: (B, K) integer, K=1 plain decode (token qi at position
    ``lengths[b] + qi``); lengths: (B,) tokens already processed.

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
    overlap probe's timing proxy, never for serving).  Returns
    (logits_local (B, K, V_loc), caches)."""
    check_supported(cfg)
    schedule = schedule or "sequential"
    if cfg.residual_wiring == "ladder" and \
            schedule not in ("ladder", "ladder_seq"):
        schedule = "ladder_seq" if schedule == "sequential" else "ladder"
    x = embed_tokens(params, tokens, cfg, ctx)
    sctx = _stage_ctx(cfg, ctx, "decode", lengths=lengths)
    sctx.block_tables = block_tables
    sctx.decode_mask = decode_mask
    sctx.kv_splits = kv_splits
    x, caches = run_stack_decode(params["periods"], cfg.block_pattern, x,
                                 caches, sctx, ctx, schedule=schedule)
    x = _final(params, x, cfg)
    return emb_lib.lm_head_local(params["embed"], x), caches
