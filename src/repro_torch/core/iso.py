"""The ISO scheduler: interleaved per-chunk execution of a transformer stack
(port of ``repro/core/iso.py``: ``attn_mlp``, ``attn_moe``, ``hybrid``,
``mlstm``/``slstm``, whisper's ``dec_block`` and bidirectional encoder).

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
so every schedule is numerically the plain stack.  A stage whose extras
carry ``post`` (the afmoe norm after a sublayer) has that function applied
to its reduced output before the residual add, in every schedule.
``lax.scan`` over periods
becomes a Python loop; the decode drivers update the caches in place (page
pools, or dense ring caches, and the recurrent states, which advance only
in the slots of ``decode_mask`` when one is given).

The ladder-residual wiring (``ladder=True`` in prefill,
``run_stack_decode_ladder`` in decode; PAPERS.md, arXiv 2501.06589) is the
other way to hide a reduce: stage k computes on the residual stream as of
stage k-2, so stage k-1's reduce completes behind stage k's compute.  It is
a different model function, chosen by ``ModelConfig.residual_wiring``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.overlap import AxisCtx, Pending, psum_now, psum_start, \
    psum_wait
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.norms import norm
from repro_torch.models.blocks import BLOCK_STAGES, STATE_KEYS, StageCtx

DECODE_SCHEDULES = ("sequential", "batch_split", "cross_block", "ladder",
                    "ladder_seq")


@dataclass
class PipeState:
    """Carry of the layer pipeline."""
    xs: Tuple[torch.Tensor, ...]           # per-chunk hidden states
    pend: Optional[Pending]                # issued reduce of the last unit
    pend_base: Optional[torch.Tensor]      # its residual base
    pend_post: Any = None                  # its stage's ``post``, or None


def _post(post, reduced: torch.Tensor) -> torch.Tensor:
    """A stage's reduced output as the residual adds it: through the
    stage's ``post`` function when it has one (blocks.py)."""
    return reduced if post is None else post(reduced)


# the page pools of a paged cache: shared by every request, never sliced
# by batch rows
PAGE_KEYS = ("k_pages", "v_pages")


def _index(v, idx):
    """``v[idx]`` of a tensor, or of each field of a state NamedTuple."""
    if isinstance(v, tuple):
        return type(v)(*(t[idx] for t in v))
    return v[idx]


def _period(tree, p: int):
    """Slice one period out of a per-position dict of period-stacked leaves
    (views: an in-place write lands in the stacked tensor)."""
    return None if tree is None else {k: _index(v, p)
                                      for k, v in tree.items()}


def _stack_states(states):
    """Per-period states of one key -> one state of period-stacked
    fields."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


def run_layer(p_layer, kind: str, state: PipeState, sctx: StageCtx,
              ctx: AxisCtx, layer_cache=None,
              starts: Sequence[int] = (0,),
              ladder: bool = False) -> Tuple[PipeState, Dict]:
    """Run one layer over all chunks in ISO order; returns extras for the
    KV scatter (``kv_k``/``kv_v`` of the call's tokens), the recurrent
    state after the call's last token (``ssm``/``mlstm``/``slstm``) and,
    for an MoE layer, ``moe_aux`` summed over the chunks.

    ``ladder=True``: the ladder-residual wiring.  The pre-resolve branch is
    skipped, so every stage computes on the residual as of two stages ago
    and the pending reduce resolves after this stage's compute.  Ladder
    runs single-chunk: an ISO interleave would resolve each chunk's pending
    during the other chunk's unit and restore the standard wiring."""
    stages = BLOCK_STAGES[kind]
    n_chunks = len(state.xs)
    assert not ladder or n_chunks == 1, "ladder wiring runs single-chunk"
    assert not ladder or all(r for _, r in stages), \
        "ladder wiring needs every stage reducing (attention-style blocks)"
    xs = list(state.xs)
    pend, pend_base, pend_post = state.pend, state.pend_base, state.pend_post
    pend_chunk = n_chunks - 1                 # invariant at layer entry
    kv_chunks: List = [None] * n_chunks
    extras_out: Dict[str, Any] = {}
    seq_state = None
    if sctx.mode == "encode":
        # bidirectional attention: every chunk attends the FULL sequence,
        # so K/V are projected once per layer from all chunks, before the
        # unit loop, from the chunks as they stand at layer entry (the last
        # chunk's pending reduce not yet applied, as in the reference)
        seq_state = attn_lib.cross_kv(p_layer["attn"], torch.cat(
            [norm(p_layer["norm1"], xc, sctx.cfg.norm_type, sctx.cfg.rms_eps)
             for xc in xs], dim=1), sctx.cfg)

    for fn, reduces in stages:
        for c in range(n_chunks):
            # a unit whose own chunk still owes a residual resolves it first
            # (the serial schedule of Figure 1(a)); with >= 2 chunks the
            # interleave resolves (s-1, c) during unit (s-1, c+1) instead.
            # Ladder skips it: the stage computes on the lagged residual
            if not ladder and pend is not None and pend_chunk == c:
                reduced, _ = psum_wait(pend)
                xs[c] = pend_base + _post(pend_post, reduced)
                pend = pend_base = pend_post = None
            out, seq_state_new, extras = fn(
                p_layer, xs[c], starts[c], seq_state, sctx, layer_cache)
            # issue this unit's reduce at once: the next unit's compute is
            # its overlap window
            started = psum_start(out, ctx) if reduces else None
            # the pending collective ran beside this unit's compute
            if pend is not None:
                reduced, (out, seq_state_new) = psum_wait(
                    pend, (out, seq_state_new))
                xs[pend_chunk] = pend_base + _post(pend_post, reduced)
                pend = pend_base = pend_post = None
            seq_state = seq_state_new
            if "kv" in extras:
                kv_chunks[c] = extras["kv"]
            if "moe_aux" in extras:
                extras_out["moe_aux"] = extras_out.get("moe_aux", 0.0) + \
                    extras["moe_aux"]
            for sk in STATE_KEYS:
                if sk in extras:
                    extras_out[sk] = extras[sk]
            if reduces:
                pend, pend_base, pend_chunk = started, xs[c], c
                pend_post = extras.get("post")
            else:
                xs[c] = xs[c] + _post(extras.get("post"), out)
        seq_state = None                      # stage boundary

    if kv_chunks[0] is not None:
        extras_out["kv_k"] = torch.cat([kv[0] for kv in kv_chunks], dim=1)
        extras_out["kv_v"] = torch.cat([kv[1] for kv in kv_chunks], dim=1)
    return PipeState(tuple(xs), pend, pend_base, pend_post), extras_out


def flush_pending(state: PipeState) -> Tuple[torch.Tensor, ...]:
    """Complete the trailing collective after the last layer."""
    xs = list(state.xs)
    if state.pend is not None:
        reduced, _ = psum_wait(state.pend)
        xs[-1] = state.pend_base + _post(state.pend_post, reduced)
    return tuple(xs)


def _run_period(params_periods, pattern, p: int, state: PipeState,
                sctx: StageCtx, ctx: AxisCtx, layer_caches, starts,
                ladder: bool):
    """One pattern period: each position's layer in turn."""
    extras = []
    for i, kind in enumerate(pattern):
        cache_i = _period(layer_caches[i], p) if layer_caches else None
        state, ex = run_layer(params_periods[i][p], kind, state, sctx, ctx,
                              layer_cache=cache_i, starts=starts,
                              ladder=ladder)
        extras.append(ex)
    return state, extras


def run_stack_prefill(params_periods, pattern: Sequence[str], x_chunks,
                      starts: Sequence[int], sctx: StageCtx, ctx: AxisCtx,
                      layer_caches=None, ladder: bool = False,
                      remat: bool = False):
    """Loop over pattern periods (the reference's ``lax.scan``).

    params_periods: per position of ``pattern``, a list of per-period layer
    params.  layer_caches: optional per-position dicts of period-stacked
    leaves, sliced per period (the reference's scanned ``layer_statics``):
    the paged prefix (``k_pages``/``v_pages`` (P, N+1, ps, Hkv, hd)), or
    whisper's cross K/V (``cross_k``/``cross_v`` (P, B, F, Hkv, hd)).
    ``starts`` are call-relative chunk offsets; a row's absolute position is
    ``sctx.pos_offset + starts[c] + t``.  Returns (x_chunks_final, per
    position extras with ``kv_k``/``kv_v``, the final recurrent state of a
    recurrent position and ``moe_aux`` for an MoE position, stacked over
    periods).  A recurrent position's ``layer_caches`` entry may carry its
    incoming state (``ssm``/``mlstm``/``slstm``, period-stacked): a
    resumed grant's carry.

    The reference starts from a zero pending reduce (``x += psum(0)``); the
    port starts with none, which is the same numbers without a collective.
    ``ladder``: the ladder-residual wiring (``run_layer``), single-chunk.
    ``remat``: each period runs under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of the reference's
    ``jax.checkpoint(period_body)``: the backward pass keeps only the
    carry between periods and recomputes a period's activations, its
    reduces included, when it reaches it."""
    n_periods = len(params_periods[0])
    state = PipeState(tuple(x_chunks), None, None)
    per_pos: List[List[Dict]] = [[] for _ in pattern]
    for p in range(n_periods):
        args = (params_periods, pattern, p, state, sctx, ctx, layer_caches,
                starts, ladder)
        if remat:
            state, extras = torch.utils.checkpoint.checkpoint(
                _run_period, *args, use_reentrant=False)
        else:
            state, extras = _run_period(*args)
        for i, ex in enumerate(extras):
            per_pos[i].append(ex)
    extras = []
    for exs in per_pos:
        e = {}
        for name in ("kv_k", "kv_v", "moe_aux"):
            if exs and name in exs[0]:
                e[name] = torch.stack([x[name] for x in exs])
        for sk in STATE_KEYS:
            if exs and sk in exs[0]:
                e[sk] = _stack_states([x[sk] for x in exs])
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


def ring_window(lengths, ring: int, K: int, device):
    """(rows, cols) of the dense ring slots a K-token window at ``lengths``
    (B,) writes: from slot ``lengths % ring``, the start clamped to ``ring -
    K`` (the reference's ``dynamic_update_slice``)."""
    lengths = lengths.to(device=device, dtype=torch.int64)
    B = lengths.shape[0]
    start = torch.clamp(lengths % ring, max=ring - K)
    rows = torch.arange(B, device=device)[:, None].expand(B, K)
    cols = start[:, None] + torch.arange(K, device=device)[None]
    return rows, cols


def _insert_ring(cache, kv_new, lengths) -> None:
    """Insert the window's K new tokens into a dense ring cache IN PLACE, at
    slot ``lengths % ring`` (``ring_window``: a multi-token insert never
    straddles the ring boundary, and the engine keeps it from needing to),
    and record their positions in ``pos``."""
    k_new, v_new = kv_new
    K = k_new.shape[1]
    dev = k_new.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    rows, cols = ring_window(lengths, cache["k"].shape[1], K, dev)
    cache["k"].index_put_((rows, cols), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((rows, cols), v_new.to(cache["v"].dtype))
    cache["pos"].index_put_((rows, cols), (lengths[:, None] + torch.arange(
        K, device=dev)[None]).to(cache["pos"].dtype))


def _apply_decode_cache_update(cache, extras, sctx: StageCtx) -> None:
    """Fold one stage's decode extras into its cache (in place): page pools
    take the window's KV through the block tables, dense ring caches insert
    it at ``lengths % ring``, and a recurrent state is replaced whole (the
    reference's wholesale replace), only in the slots of
    ``sctx.decode_mask`` when it is given (the paged engine's slots that
    really decoded; the reference selects them after the stack, the same
    numbers since no slot's state reads another's)."""
    if cache is None:
        return
    if "kv" in extras:
        if "k_pages" in cache:
            _scatter_token_to_pages(cache, extras["kv"], sctx.lengths,
                                    sctx.block_tables, sctx.decode_mask)
        elif "k" in cache:
            _insert_ring(cache, extras["kv"], sctx.lengths)
    for sk in STATE_KEYS:
        if sk in extras and sk in cache:
            for old, new in zip(cache[sk], extras[sk]):
                if sctx.decode_mask is not None:
                    keep = sctx.decode_mask.reshape(
                        (-1,) + (1,) * (old.ndim - 1))
                    new = torch.where(keep, new.to(old.dtype), old)
                old.copy_(new)


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
    * ``"ladder"`` / ``"ladder_seq"``: ``run_stack_decode_ladder``, deferred
      / immediate (the ladder-rewired function).
    """
    if schedule in ("ladder", "ladder_seq"):
        return run_stack_decode_ladder(params_periods, pattern, x, caches,
                                       sctx, ctx, defer=schedule == "ladder")
    if schedule == "batch_split":
        return run_stack_decode_overlap(params_periods, pattern, x, caches,
                                        sctx, ctx)
    if schedule not in ("sequential", "cross_block"):
        raise ValueError(f"unknown decode schedule {schedule!r}; one of "
                         f"{DECODE_SCHEDULES}")
    defer = schedule == "cross_block"
    pend = pend_post = None
    for p in range(len(params_periods[0])):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            for fn, reduces in BLOCK_STAGES[kind]:
                if pend is not None:          # cross-block: resolve here
                    x = x + _post(pend_post, psum_wait(pend)[0])
                    pend = None
                out, _, extras = fn(params_periods[i][p], x, 0, None, sctx,
                                    cache_i)
                post = extras.get("post")
                if reduces and defer:
                    pend = psum_start(out, ctx)       # scatter in the window
                    pend_post = post
                elif reduces:
                    x = x + _post(post, psum_now(out, ctx))
                else:
                    x = x + _post(post, out)
                _apply_decode_cache_update(cache_i, extras, sctx)
    if pend is not None:
        x = x + _post(pend_post, psum_wait(pend)[0])
    return x, caches


def run_stack_decode_ladder(params_periods, pattern: Sequence[str], x,
                            caches, sctx: StageCtx, ctx: AxisCtx,
                            defer: bool = True):
    """Ladder-residual decode (PAPERS.md, arXiv 2501.06589): stage k
    consumes the residual stream as of stage k-2,

        input_k = x_emb + sum_{j <= k-2} AR(out_j),

    so ``AR(out_{k-1})`` is independent of stage k's compute and completes
    behind it, across block and period boundaries.  It needs no second
    batch half (B = 1 works) and no sequence chunk: the lag is the overlap
    window.  The pending partial is carried by the Python loop over periods
    (the reference's ``lax.scan`` carry).

    ``defer=True`` issues each stage's reduce as soon as its partial exists
    and completes it after the next stage's compute; ``defer=False`` is the
    schedule twin of the SAME ladder function, each reduce run immediately
    (``psum_now``) after the next stage's compute.  Both do the same
    reduces and residual adds in the same order, so they are bit-equal.
    The reference starts from a zero pending (``x += psum(0)``); the port
    starts with none, the same numbers without a collective."""
    for kind in pattern:
        assert all(r for _, r in BLOCK_STAGES[kind]), \
            "ladder wiring needs every stage reducing (attention-style blocks)"
    pend = pend_post = None   # deferred: the issued reduce; else the partial
    for p in range(len(params_periods[0])):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            for fn, _ in BLOCK_STAGES[kind]:
                # compute on the LAGGED residual (the pending not yet added)
                out, _, extras = fn(params_periods[i][p], x, 0, None, sctx,
                                    cache_i)
                if defer:
                    started = psum_start(out, ctx)
                    if pend is not None:    # ran beside this stage's compute
                        x = x + _post(pend_post, psum_wait(pend)[0])
                    pend = started
                else:
                    if pend is not None:
                        x = x + _post(pend_post, psum_now(pend, ctx))
                    pend = out
                pend_post = extras.get("post")
                _apply_decode_cache_update(cache_i, extras, sctx)
    if pend is not None:                    # trailing flush
        x = x + _post(pend_post, psum_wait(pend)[0] if defer
                      else psum_now(pend, ctx))
    return x, caches


def run_stack_decode_overlap(params_periods, pattern: Sequence[str], x,
                             caches, sctx: StageCtx, ctx: AxisCtx):
    """Decode with the ISO schedule extended to the BATCH dimension.

    At decode there is no sequence to split, but a continuous-batching step
    carries independent requests, so slots [0, B/2) and [B/2, B) are the two
    "chunks".  They share no state (separate KV pages and recurrent
    slots), so there is no cross-chunk edge: each half's reduce is started
    as soon as its partial exists, its KV scatter lands inside the window,
    and the OTHER half's
    pending reduce completes after this half's compute.  Paged pools are
    shared by both halves and scattered in place; dense ring caches (and
    recurrent states) are split with the batch, each half writing its own
    rows in place (the reference runs this schedule on paged caches only;
    no engine or dry-run cell gives it dense caches, ``api.decode_step``
    takes them).
    ``B < 2`` has no second half and runs the sequential schedule."""
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
    pend, pend_base, pend_h, pend_post = None, None, 1, None
    for p in range(len(params_periods[0])):
        for i, kind in enumerate(pattern):
            cache_i = _period(caches[i], p)
            # each half reads and advances its own slots' rows (views); the
            # page pools are shared whole
            halves = [None if cache_i is None else
                      {k: v if k in PAGE_KEYS else _index(v, slice(lo, hi))
                       for k, v in cache_i.items()} for lo, hi in bounds]
            for fn, reduces in BLOCK_STAGES[kind]:
                for h in range(2):
                    out, _, extras = fn(params_periods[i][p], xs[h], 0, None,
                                        sctxs[h], halves[h])
                    started = psum_start(out, ctx) if reduces else None
                    _apply_decode_cache_update(halves[h], extras, sctxs[h])
                    # the other half's reduce ran beside this half's compute
                    if pend is not None:
                        xs[pend_h] = pend_base + _post(pend_post,
                                                       psum_wait(pend)[0])
                        pend = None
                    if reduces:
                        pend, pend_base, pend_h = started, xs[h], h
                        pend_post = extras.get("post")
                    else:
                        xs[h] = xs[h] + _post(extras.get("post"), out)
    if pend is not None:
        xs[pend_h] = pend_base + _post(pend_post, psum_wait(pend)[0])
    return torch.cat(xs, dim=0), caches
