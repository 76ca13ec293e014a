"""The ISO scheduler: interleaved per-chunk execution of a transformer stack
(port of ``repro/core/iso.py``, dense subset).

ISO splits the sequence into chunks and walks the (stage x chunk) grid in the
order of the paper's Figure 1(d):

    unit order:  (s1,c0) (s1,c1) (s2,c0) (s2,c1) | next layer (s1,c0) ...

At every unit the unit's partial is computed FIRST, then the previous unit's
pending collective completes (``psum_wait``) and its residual is applied; the
pending collective crosses layer boundaries.  The KV prefix is threaded
chunk to chunk within each layer.  At tp=1 the collectives are identities, so
the schedule is numerically the plain stack.  ``lax.scan`` over periods
becomes a Python loop; the decode driver updates the page pools in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.overlap import AxisCtx, psum_now, psum_start, psum_wait
from repro_torch.models.blocks import BLOCK_STAGES, StageCtx


@dataclass
class PipeState:
    """Carry of the layer pipeline."""
    xs: Tuple[torch.Tensor, ...]           # per-chunk hidden states
    pend_partial: Optional[torch.Tensor]   # unreduced partial of the last unit
    pend_base: Optional[torch.Tensor]      # its residual base


def _kind_reduces_last(kind: str) -> bool:
    return BLOCK_STAGES[kind][-1][1]


def _period(tree, p: int):
    """Slice one period out of a per-position dict of period-stacked leaves."""
    return None if tree is None else {k: v[p] for k, v in tree.items()}


def run_layer(p_layer, kind: str, state: PipeState, sctx: StageCtx,
              ctx: AxisCtx, layer_cache=None,
              starts: Sequence[int] = (0,)) -> Tuple[PipeState, Dict]:
    """Run one layer over all chunks in ISO order; returns extras for the
    KV scatter (``kv_k``/``kv_v`` of the call's tokens)."""
    stages = BLOCK_STAGES[kind]
    n_chunks = len(state.xs)
    xs = list(state.xs)
    pend_partial, pend_base = state.pend_partial, state.pend_base
    pend_chunk = n_chunks - 1                 # invariant at layer entry
    kv_chunks: List = [None] * n_chunks
    seq_state = None

    for s_idx, (fn, reduces) in enumerate(stages):
        for c in range(n_chunks):
            # a unit whose own chunk still owes a residual resolves it first
            # (the serial schedule of Figure 1(a)); with >= 2 chunks the
            # interleave resolves (s-1, c) during unit (s-1, c+1) instead
            if pend_partial is not None and pend_chunk == c:
                reduced, _ = psum_wait(psum_start(pend_partial, ctx))
                xs[pend_chunk] = pend_base + reduced
                pend_partial = pend_base = None
            out, seq_state_new, extras = fn(
                p_layer, xs[c], starts[c], seq_state, sctx, layer_cache)
            # resolve the pending collective, hidden behind this unit
            if pend_partial is not None:
                reduced, (out, seq_state_new) = psum_wait(
                    psum_start(pend_partial, ctx), (out, seq_state_new))
                xs[pend_chunk] = pend_base + reduced
                pend_partial = pend_base = None
            seq_state = seq_state_new
            if "kv" in extras:
                kv_chunks[c] = extras["kv"]
            if reduces:
                pend_partial, pend_base, pend_chunk = out, xs[c], c
            else:
                xs[c] = xs[c] + out
        seq_state = None                      # stage boundary

    extras_out: Dict[str, Any] = {}
    if kv_chunks[0] is not None:
        extras_out["kv_k"] = torch.cat([kv[0] for kv in kv_chunks], dim=1)
        extras_out["kv_v"] = torch.cat([kv[1] for kv in kv_chunks], dim=1)
    return PipeState(tuple(xs), pend_partial, pend_base), extras_out


def flush_pending(state: PipeState, ctx: AxisCtx) -> Tuple[torch.Tensor, ...]:
    """Complete the trailing collective after the last layer."""
    xs = list(state.xs)
    if state.pend_partial is not None:
        reduced, _ = psum_wait(psum_start(state.pend_partial, ctx))
        xs[-1] = state.pend_base + reduced
    return tuple(xs)


def init_pipe_state(x_chunks: Sequence[torch.Tensor], pattern: Sequence[str]
                    ) -> PipeState:
    """Zero pending (exact no-op: x += psum(0)) when the pattern ends in a
    reducing stage; None pending otherwise."""
    if _kind_reduces_last(pattern[-1]):
        z = torch.zeros_like(x_chunks[-1])
        return PipeState(tuple(x_chunks), z, x_chunks[-1] * 0 + x_chunks[-1])
    return PipeState(tuple(x_chunks), None, None)


def run_stack_prefill(params_periods, pattern: Sequence[str], x_chunks,
                      starts: Sequence[int], sctx: StageCtx, ctx: AxisCtx,
                      layer_caches=None):
    """Loop over pattern periods (the reference's ``lax.scan``).

    params_periods: per position of ``pattern``, a list of per-period layer
    params.  layer_caches: optional per-position dicts of period-stacked
    leaves (the paged prefix: ``k_pages``/``v_pages`` (P, N+1, ps, Hkv, hd)).
    ``starts`` are call-relative chunk offsets; a row's absolute position is
    ``sctx.pos_offset + starts[c] + t``.  Returns (x_chunks_final, per
    position extras with ``kv_k``/``kv_v`` stacked over periods)."""
    n_periods = len(params_periods[0])
    state = init_pipe_state(x_chunks, pattern)
    per_pos: List[List[Dict]] = [[] for _ in pattern]
    for p in range(n_periods):
        for i, kind in enumerate(pattern):
            cache_i = _period(layer_caches[i], p) if layer_caches else None
            state, extras = run_layer(params_periods[i][p], kind, state, sctx,
                                      ctx, layer_cache=cache_i, starts=starts)
            per_pos[i].append(extras)
    extras = []
    for exs in per_pos:
        e = {}
        if exs and "kv_k" in exs[0]:
            e["kv_k"] = torch.stack([x["kv_k"] for x in exs])
            e["kv_v"] = torch.stack([x["kv_v"] for x in exs])
        extras.append(e)
    return flush_pending(state, ctx), tuple(extras)


def _scatter_token_to_pages(cache, kv_new, lengths, block_tables,
                            decode_mask) -> None:
    """Scatter the decode window's (k, v) straight into block-table pages,
    IN PLACE (``index_put_`` on the period's pool view; the reference builds
    a new pool with ``.at[].set``).

    kv_new: (B, K, Hkv, hd), window token qi lands at ``lengths[b] + qi``.
    Inactive slots (and positions with no capacity) route to the scratch
    page."""
    from repro_torch.serving.kvcache import window_page_coords
    k_new, v_new = kv_new
    kp, vp = cache["k_pages"], cache["v_pages"]          # (N+1, ps, Hkv, hd)
    page, off, _, _ = window_page_coords(
        lengths, block_tables, k_new.shape[1], kp.shape[1],
        scratch=kp.shape[0] - 1, decode_mask=decode_mask)
    kp.index_put_((page, off), k_new.to(kp.dtype))
    vp.index_put_((page, off), v_new.to(vp.dtype))


def _apply_decode_cache_update(cache, extras, sctx: StageCtx) -> None:
    """Fold one stage's decode extras into its cache (in place)."""
    if cache is not None and "kv" in extras and "k_pages" in cache:
        _scatter_token_to_pages(cache, extras["kv"], sctx.lengths,
                                sctx.block_tables, sctx.decode_mask)


def run_stack_decode(params_periods, pattern: Sequence[str], x, caches,
                     sctx: StageCtx, ctx: AxisCtx,
                     schedule: str = "sequential"):
    """Decode (x: (B,K,D)) with cache read + in-place page update per layer.
    caches: per position, dicts of period-stacked page pools.  Only the
    ``"sequential"`` schedule (an immediate reduce per stage) is ported; the
    deferred schedules are ROADMAP queue A item 7."""
    if schedule != "sequential":
        raise NotImplementedError(
            f"decode schedule {schedule!r}: the port runs 'sequential' only "
            f"(ROADMAP queue A item 7)")
    n_periods = len(params_periods[0])
    for p in range(n_periods):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            for fn, reduces in BLOCK_STAGES[kind]:
                out, _, extras = fn(params_periods[i][p], x, 0, None, sctx,
                                    cache_i)
                x = x + (psum_now(out, ctx) if reduces else out)
                _apply_decode_cache_update(cache_i, extras, sctx)
    return x, caches
