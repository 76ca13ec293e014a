"""Overlap-efficiency probe: how much decode all-reduce does each schedule
hide?  (Port of ``repro/obs/overlap_probe.py``.)

Times the decode collective schedules (core/iso.py) against each other on
IDENTICAL synthetic batches through the paged engine's own closures:

  * ``sequential``: an immediate reduce a stage (the baseline);
  * ``batch_split``: each batch half's reduce runs beside the other half's
    compute (``run_stack_decode_overlap``; needs B >= 2);
  * ``ladder``: the ladder-residual decode stack with deferred collectives
    (``run_stack_decode_ladder``);
  * ``cross_block``: each reduce resolved at the next stage's top;

and decomposes the step:

    overlap_efficiency        = 1 - t_batch_split / t_sequential
    overlap_efficiency_ladder = 1 - t_ladder / t_sequential
    ladder_speedup            = t_sequential / t_ladder
    hidden_comm               = max(0, t_sequential - t_batch_split)
    exposed_comm              = max(0, t_batch_split - t_compute)

``t_compute`` comes from a closure with the collectives off (a bare
``AxisCtx``, every reduce the identity): the compute floor.  On a
standard-wired engine the ladder time is a proxy, the ladder-rewired
function at the same shapes (the twins do the same FLOPs;
``ladder_proxy=True``).  On a ladder-wired engine ``sequential`` is the
immediate-collective twin of the same ladder function and ``batch_split``
and ``cross_block`` are skipped.

What it can show here: at tp=1 there is no collective, the schedules
coincide and every efficiency is about 0; at tp=2 on one card the ranks
reduce over gloo through host memory, which shows the host's cost of each
schedule, not an overlap on the card.  Neither supports an overlap claim,
which needs NCCL on several cards (ROADMAP queue A item 7).

Timing: on the card, CUDA events around each call (after a warm-up); on the
CPU, ``time.perf_counter`` around each call between synchronisations.  The
median of ``iters`` calls a schedule.  At tp=1 on the card each closure is
captured in a CUDA graph like a serving closure, so a call is one replay.

Safety: the probe's closures live in ``engine._probe_decode_fns`` (never
``_decode_fns``) and their captures do not count in ``engine.graphs``.
Inputs are synthetic: a full batch of block tables over real pool pages
with lengths one short of each row's capacity (the memory-bound regime).
The port's closures scatter the window's KV in place, so the probe saves
the one page a row it writes and puts it back after: the engine's pools,
allocator and host state come out as they went in.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.models.blocks import pattern_all_reduces


def _median_time(call, device: torch.device, iters: int,
                 warmup: int) -> float:
    """Median seconds of ``call()`` over ``iters`` calls after ``warmup``."""
    for _ in range(max(1, warmup)):
        call()
    synchronize(device)
    samples = []
    for _ in range(max(1, iters)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call()
            samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def decode_overlap_probe(engine, iters: int = 10, warmup: int = 3
                         ) -> Dict[str, Any]:
    """Measure the engine's decode step time under each schedule.

    Returns the reference's keys: ``{overlap_efficiency,
    overlap_efficiency_ladder, ladder_speedup, ladder_proxy, schedules,
    t_sequential_s, t_overlap_s, t_ladder_s, t_cross_block_s, t_compute_s,
    exposed_comm_s, hidden_comm_s, comm_total_s, batch, tokens_resident,
    tp, iters}``.  ``t_overlap_s`` is the batch-split time (0.0 when
    B < 2), and ``exposed_comm_s`` is None then."""
    B = engine.max_batch
    ps, MB = engine.ps, engine.max_blocks
    ladder_wired = engine.cfg.residual_wiring == "ladder"
    result: Dict[str, Any] = {
        "overlap_efficiency": 0.0, "overlap_efficiency_ladder": 0.0,
        "ladder_speedup": 0.0, "ladder_proxy": not ladder_wired,
        "schedules": {}, "t_sequential_s": 0.0, "t_overlap_s": 0.0,
        "t_ladder_s": 0.0, "t_cross_block_s": 0.0,
        "t_compute_s": None, "exposed_comm_s": None, "hidden_comm_s": 0.0,
        "comm_total_s": None, "batch": B, "tokens_resident": 0,
        "tp": engine.tp, "iters": iters,
    }

    # synthetic resident state: every slot holds as many pages as an even
    # split of the pool allows, its length one short of capacity, so the
    # decode token lands in the row's last page (the tables are fake: no
    # allocator involvement)
    blocks_per_row = max(1, min(MB, engine.alloc.num_pages // B))
    L = blocks_per_row * ps - 1
    result["tokens_resident"] = L * B
    bt = np.full((B, MB), -1, np.int32)
    for b in range(B):
        bt[b, :blocks_per_row] = np.arange(
            b * blocks_per_row, (b + 1) * blocks_per_row, dtype=np.int32)
    host = dict(toks=np.zeros((B, 1), np.int32), bt=bt,
                lengths=np.full(B, L, np.int32), mask=np.ones(B, bool))
    # the pages the window's KV scatter writes: each row's last
    written = torch.tensor(bt[:, blocks_per_row - 1].astype(np.int64),
                           device=engine.device)
    pools = engine.kv.k + engine.kv.v
    saved = [pool.index_select(1, written) for pool in pools]
    # the recurrent states every decode advances (a recurrent stack's)
    states = [(t, t.clone()) for t in engine._state_tensors]

    def run(fn) -> float:
        if fn.graphed and fn.graph is None:
            fn.stage(**host)
            fn.capture(engine._capture_stream, engine._graph_pool)
        fn.stage(**host)
        return _median_time(fn, engine.device, iters, warmup)

    # on a ladder-wired engine "sequential"/"ladder" are the immediate and
    # deferred twins of the ladder function (models/decoder.decode_step);
    # cross_block and batch_split apply to the standard wiring only
    names = ["sequential", "ladder"] if ladder_wired else \
        ["sequential", "batch_split", "ladder", "cross_block"]
    if B < 2 and "batch_split" in names:
        names.remove("batch_split")       # batch-split needs two halves
    if not pattern_all_reduces(engine.cfg.block_pattern):
        names.remove("ladder")            # ladder needs all-reducing stages
    try:
        for name in names:
            result["schedules"][name] = run(engine._get_probe_decode(name))
        t_cmp = run(engine._get_probe_decode("sequential", comm=False))
    finally:
        for pool, keep in zip(pools, saved):
            pool.index_copy_(1, written, keep)
        for t, keep in states:
            t.copy_(keep)
        synchronize(engine.device)
    t_seq = result["t_sequential_s"] = result["schedules"]["sequential"]
    t_ovl = result["t_overlap_s"] = result["schedules"].get("batch_split",
                                                            0.0)
    t_lad = result["t_ladder_s"] = result["schedules"].get("ladder", 0.0)
    result["t_cross_block_s"] = result["schedules"].get("cross_block", 0.0)
    if t_seq > 0 and t_ovl > 0:
        result["overlap_efficiency"] = 1.0 - t_ovl / t_seq
    if t_seq > 0 and t_lad > 0:
        result["overlap_efficiency_ladder"] = 1.0 - t_lad / t_seq
        result["ladder_speedup"] = t_seq / t_lad
    result["hidden_comm_s"] = max(0.0, t_seq - t_ovl) if t_ovl > 0 else 0.0
    result["t_compute_s"] = t_cmp
    if t_ovl > 0:
        result["exposed_comm_s"] = max(0.0, t_ovl - t_cmp)
    result["comm_total_s"] = max(0.0, t_seq - t_cmp)
    return result
