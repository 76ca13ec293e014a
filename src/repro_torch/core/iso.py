"""The ISO scheduler: interleaved per-chunk execution of a transformer stack
(port of ``repro/core/iso.py``, dense subset).

ISO splits the sequence into chunks and walks the (stage x chunk) grid in the
order of the paper's Figure 1(d):

    unit order:  (s1,c0) (s1,c1) (s2,c0) (s2,c1) | next layer (s1,c0) ...

A unit's partial is handed to ``psum_start`` as soon as it exists; the NEXT
unit's compute is enqueued, and only then does ``psum_wait`` complete the
collective and apply its residual, so each all-reduce runs beside the other
chunk's compute.  Eager PyTorch keeps the program order, so this issue
order IS the schedule (the reference leaves the placement to XLA).  The
pending collective crosses layer boundaries.  The KV prefix is threaded
chunk to chunk within each layer.  At tp=1 the collectives are identities,
so every schedule is numerically the plain stack.  ``lax.scan`` over periods
becomes a Python loop; the decode drivers update the page pools in place.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.overlap import AxisCtx, Pending, psum_now, psum_start, \
    psum_wait
from repro_torch.models.blocks import BLOCK_STAGES, StageCtx

DECODE_SCHEDULES = ("sequential", "batch_split", "cross_block")


@dataclass
class PipeState:
    """Carry of the layer pipeline."""
    xs: Tuple[torch.Tensor, ...]           # per-chunk hidden states
    pend: Optional[Pending]                # issued reduce of the last unit
    pend_base: Optional[torch.Tensor]      # its residual base


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
    pend, pend_base = state.pend, state.pend_base
    pend_chunk = n_chunks - 1                 # invariant at layer entry
    kv_chunks: List = [None] * n_chunks
    seq_state = None

    for fn, reduces in stages:
        for c in range(n_chunks):
            # a unit whose own chunk still owes a residual resolves it first
            # (the serial schedule of Figure 1(a)); with >= 2 chunks the
            # interleave resolves (s-1, c) during unit (s-1, c+1) instead
            if pend is not None and pend_chunk == c:
                reduced, _ = psum_wait(pend)
                xs[c] = pend_base + reduced
                pend = pend_base = None
            out, seq_state_new, extras = fn(
                p_layer, xs[c], starts[c], seq_state, sctx, layer_cache)
            # issue this unit's reduce at once: the next unit's compute is
            # its overlap window
            started = psum_start(out, ctx) if reduces else None
            # the pending collective ran beside this unit's compute
            if pend is not None:
                reduced, (out, seq_state_new) = psum_wait(
                    pend, (out, seq_state_new))
                xs[pend_chunk] = pend_base + reduced
                pend = pend_base = None
            seq_state = seq_state_new
            if "kv" in extras:
                kv_chunks[c] = extras["kv"]
            if reduces:
                pend, pend_base, pend_chunk = started, xs[c], c
            else:
                xs[c] = xs[c] + out
        seq_state = None                      # stage boundary

    extras_out: Dict[str, Any] = {}
    if kv_chunks[0] is not None:
        extras_out["kv_k"] = torch.cat([kv[0] for kv in kv_chunks], dim=1)
        extras_out["kv_v"] = torch.cat([kv[1] for kv in kv_chunks], dim=1)
    return PipeState(tuple(xs), pend, pend_base), extras_out


def flush_pending(state: PipeState) -> Tuple[torch.Tensor, ...]:
    """Complete the trailing collective after the last layer."""
    xs = list(state.xs)
    if state.pend is not None:
        reduced, _ = psum_wait(state.pend)
        xs[-1] = state.pend_base + reduced
    return tuple(xs)


def run_stack_prefill(params_periods, pattern: Sequence[str], x_chunks,
                      starts: Sequence[int], sctx: StageCtx, ctx: AxisCtx,
                      layer_caches=None):
    """Loop over pattern periods (the reference's ``lax.scan``).

    params_periods: per position of ``pattern``, a list of per-period layer
    params.  layer_caches: optional per-position dicts of period-stacked
    leaves (the paged prefix: ``k_pages``/``v_pages`` (P, N+1, ps, Hkv, hd)).
    ``starts`` are call-relative chunk offsets; a row's absolute position is
    ``sctx.pos_offset + starts[c] + t``.  Returns (x_chunks_final, per
    position extras with ``kv_k``/``kv_v`` stacked over periods).

    The reference starts from a zero pending reduce (``x += psum(0)``); the
    port starts with none, which is the same numbers without a collective."""
    n_periods = len(params_periods[0])
    state = PipeState(tuple(x_chunks), None, None)
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
    return flush_pending(state), tuple(extras)


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
    caches: per position, dicts of period-stacked page pools.

    ``schedule``:

    * ``"sequential"``: an immediate reduce per reducing stage.
    * ``"cross_block"``: every reduce is started at the end of its stage and
      resolved at the top of the next one, across block and period
      boundaries, so the stage's KV page scatter runs inside the window.
      Same reduces and residual adds in the same order as sequential.
    * ``"batch_split"``: ``run_stack_decode_overlap``.
    """
    if schedule == "batch_split":
        return run_stack_decode_overlap(params_periods, pattern, x, caches,
                                        sctx, ctx)
    if schedule not in ("sequential", "cross_block"):
        raise ValueError(f"unknown decode schedule {schedule!r}; one of "
                         f"{DECODE_SCHEDULES}")
    defer = schedule == "cross_block"
    pend = None
    for p in range(len(params_periods[0])):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            for fn, reduces in BLOCK_STAGES[kind]:
                if pend is not None:          # cross-block: resolve here
                    x = x + psum_wait(pend)[0]
                    pend = None
                out, _, extras = fn(params_periods[i][p], x, 0, None, sctx,
                                    cache_i)
                if reduces and defer:
                    pend = psum_start(out, ctx)       # scatter in the window
                elif reduces:
                    x = x + psum_now(out, ctx)
                else:
                    x = x + out
                _apply_decode_cache_update(cache_i, extras, sctx)
    if pend is not None:
        x = x + psum_wait(pend)[0]
    return x, caches


def run_stack_decode_overlap(params_periods, pattern: Sequence[str], x,
                             caches, sctx: StageCtx, ctx: AxisCtx):
    """Decode with the ISO schedule extended to the BATCH dimension.

    At decode there is no sequence to split, but a continuous-batching step
    carries independent requests, so slots [0, B/2) and [B/2, B) are the two
    "chunks".  They share no state (separate KV pages), so there is no
    cross-chunk edge: each half's reduce is started as soon as its partial
    exists, its KV scatter lands inside the window, and the OTHER half's
    pending reduce completes after this half's compute.  Paged caches only;
    the pools are shared by both halves and scattered in place.  ``B < 2``
    has no second half and runs the sequential schedule."""
    B = x.shape[0]
    if B < 2:
        return run_stack_decode(params_periods, pattern, x, caches, sctx, ctx)
    B2 = B // 2
    bounds = ((0, B2), (B2, B))

    def sctx_half(lo, hi):
        return replace(
            sctx, lengths=sctx.lengths[lo:hi],
            block_tables=None if sctx.block_tables is None
            else sctx.block_tables[lo:hi],
            decode_mask=None if sctx.decode_mask is None
            else sctx.decode_mask[lo:hi])

    sctxs = [sctx_half(lo, hi) for lo, hi in bounds]
    xs = [x[lo:hi] for lo, hi in bounds]
    pend, pend_base, pend_h = None, None, 1
    for p in range(len(params_periods[0])):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            for fn, reduces in BLOCK_STAGES[kind]:
                for h in range(2):
                    out, _, extras = fn(params_periods[i][p], xs[h], 0, None,
                                        sctxs[h], cache_i)
                    started = psum_start(out, ctx) if reduces else None
                    _apply_decode_cache_update(cache_i, extras, sctxs[h])
                    # the other half's reduce ran beside this half's compute
                    if pend is not None:
                        xs[pend_h] = pend_base + psum_wait(pend)[0]
                        pend = None
                    if reduces:
                        pend, pend_base, pend_h = started, xs[h], h
                    else:
                        xs[h] = xs[h] + out
    if pend is not None:
        xs[pend_h] = pend_base + psum_wait(pend)[0]
    return torch.cat(xs, dim=0), caches
