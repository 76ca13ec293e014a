#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Phases, each fatal on failure:

  1. build     compile the port's CUDA kernels from ``src/repro_torch/kernels/
               csrc`` with nvcc, one process per source, all at once; print
               the build time, the compiler's register/shared-memory report
               (and the register and spill lines of the bf16 tensor-core
               instantiations apart) and the card's name and power limit.
  2. kernels   hold each kernel against its plain PyTorch version on the
               card: the paged attention kernels at the serving path's
               shapes (hd 128, ps 16, Hq/Hkv 32/8 at tp=1 and one rank's
               16/4 at tp=2, lengths 1..2048 across page boundaries, S in
               {1, 4}, window 0 and > 0, 512- and 256-query chunks with
               fresh rows beside resumed rows) and at the CPU tests' shapes
               (hd 16, ps 8), fp32 and bf16, dead-page skip bit-identical;
               the bf16 paged-prefill tile loop's edges (hd 64/80/256 x ps
               8/16/32 x group 1/2/4/8, Sq 100, prefixes off the 64-key
               grid, windows that leave rows with no key, which must come
               back neutral, group 80, hd 20);
               the paged decode kernel's edges (hd 64/80/256/20/18, ps 32/64,
               query rows 1/12/32/33/40/48/64, 8192 and 3000 tokens on
               clustered grids, rows and batches with no key; every span
               partial with no key must come back neutral); at S > 1 the
               split-KV fold inside the decode launch EQUAL to the
               standalone reduce of the same partials, and the fold's
               arrival counters back at 0 after launches in a row and after
               CUDA-graph replays;
               the int8 quantize kernel over bf16/fp32 rows of width
               64..4096 (the 16-byte and the scalar path, an all-zero row,
               .5 ties), q and scales EQUAL to the plain version, and the
               int8 all-reduce's three kernels (shards quantize, rank sum
               and re-quantize, gathered dequantize) at tp 2 and 4 EQUAL to
               theirs; the dense
               flash-prefill kernel at the CPU tests' shapes and at full
               width (Hq/Hkv 32/8, 16/4, hd 128), MHA, GQA and MQA, ragged
               Sq/Sk, causal or not, windows > 0, rows with no key (0),
               hd 16..256; RMSNorm and SwiGLU over fp32/bf16 rows up to
               (2048, 4096) and (2048, 12288), fp32 and bf16 gamma, widths
               and addresses that forbid 16-byte loads.
  3. serve     the tp=1 path: ``PagedEngine`` serving qwen3-8b at full width
               and depth in bf16 (random weights from a seed) on 6 greedy
               requests of 300-2000 prompt tokens, first on an eager engine
               (``cuda_graphs=False``), then on a graphed one (each decode
               step and each bucket-padded grant one CUDA-graph replay): a
               capture pass, then a timed pass of replays only.  Both
               graphed passes must give the eager tokens; the graph count
               must stay within the closure keys' bound; logits finite,
               every request complete and every page free after each pass;
               in the timed pass, counted through the replays, the paged
               decode and prefill kernels must have launched, every
               paged-prefill launch on the bf16 tensor-core instantiation,
               the decode kernel with the fold inside once a layer of every
               step at S > 1 (by the engine's record of S) and the
               standalone reduce never, and the fold's arrival counters
               must read 0 after it; the graphed decode dispatch share must
               be below the eager one.  Prints each engine's prefill tok/s,
               decode ms/step, dispatch shares and peak memory (allocated
               and reserved), the graph count, capture seconds and the
               reserved memory after each capture, and the device's idle
               share over ten graphed decode steps (a lower bound from CUDA
               events around each step's staging and replay, and the
               ``torch.profiler`` figure with CUDA activities, checked
               against those events) with the kernels that took the most
               device time.
  4. parity    a tiny fp32 model served on ``cuda`` and on ``cpu`` from the
               same weights must give equal greedy tokens (mixed traffic,
               forced 4-way split-KV decode, forced preemption).
  5. tp        this slice's path, tensor parallelism at tp=2, run as two
               rank processes sharing the one card over gloo (NCCL refuses
               two ranks on one device; gloo moves every collective through
               host memory, so the run proves the sharded model, the local
               head counts, the int8 reduce and the ISO issue order on CUDA
               tensors, and measures no overlap).  qwen3-8b at full width
               and depth, bf16, each rank holding half the weights, serves
               3 greedy requests of 300-1200 prompt tokens (a resumed grant,
               split-KV decode) under the default batch-split schedule and
               the sequential one, each again with ``quantized_comm``, whose
               runs must launch the int8 reduce's three kernels once each a
               reduce, and B7 alone never; the host time spent inside
               the reduces is recorded, and one reduce is timed alone in the
               sequential and the batch-split issue order; then a tiny fp32
               model at tp=2 must give the tokens of tp=1 on the card under
               all three decode schedules.
  6. time      each kernel and its plain version at the main path's shapes
               (the decode kernel with its fold, and the walk alone, the
               fold's cost being the difference; also at one tp=2 rank's
               heads and at one request of 8192 tokens; the standalone
               reduce; the int8 kernel at both its decode and its prefill
               shapes; the int8 all-reduce's three kernels, and one
               reduce's local part against the composition of B7
               and PyTorch ops at the decode and prefill shapes; the paged
               prefill at a 512-query chunk and at the serving
               path's 256-query ISO chunk, both over a 1024-token prefix),
               and where one PyTorch call computes the same function, that
               call (SDPA for the flash-prefill kernel, ``F.rms_norm``);
               then the per-launch floor (a trivial launch through the same
               graph replay) and each row's gap to max(bound, floor).
  7. ops       the kernel entry point ``repro_torch.kernels.ops`` at
               qwen3-8b's widths in bf16: the ISO composition, a 2048-token
               prompt as two 1024-token chunks, flash(chunk 0) ++
               flash(chunk 1 | prefix) == flash(all 2048), at tp=1's heads
               (32/8, hd 128) and one tp=2 rank's (16/4); ``rms_norm`` at
               (2048, 4096) with an fp32 gamma; ``swiglu`` at (2048, 12288)
               and one rank's (2048, 6144); ``quantize_int8`` at (2048,
               4096).  Each call is held against its plain version; the four
               kernels must have launched.

Each launch count in the kernel line is read from the run of the path that
launches it, with the counts set to 0 just before: the attention kernels
from phase 3 (``decode_reduce``: the decode launches that ran its fold,
``native.VARIANTS["paged_decode/fold"]``; its times are the standalone
kernel's, which runs the same fold code), the int8 reduce's three kernels
from rank 0 of phase 5's quantized batch-split run, the flash-prefill,
RMSNorm, SwiGLU and int8 quantize kernels from phase 7 (the serving path
does not launch them).  It
imports nothing of JAX or of the JAX package.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit from nvidia-smi, and before that a JSON line with each kernel's
launches, error, times and bound.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# tolerances of kernel vs plain version (both accumulate in fp32 over the
# same inputs; they differ only in summation order)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SOURCES = {
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                     "src/repro/kernels/flash_decode.py:92"),
    "decode_reduce": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                      "src/repro/kernels/flash_decode.py:154"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                      "src/repro/kernels/flash_prefill_paged.py:73"),
    "quantize_int8": ("src/repro_torch/kernels/csrc/int8_quant.cu",
                      "src/repro/kernels/int8_quant.py:18"),
    # the int8 all-reduce's local steps (B7 and the XLA ops around it in
    # the reference's quantized_psum)
    "quantize_int8_shards": ("src/repro_torch/kernels/csrc/int8_quant.cu",
                             "src/repro/core/quantized_collectives.py:65"),
    "dequant_sum_quantize_int8": (
        "src/repro_torch/kernels/csrc/int8_quant.cu",
        "src/repro/core/quantized_collectives.py:71"),
    "dequantize_int8_gathered": (
        "src/repro_torch/kernels/csrc/int8_quant.cu",
        "src/repro/core/quantized_collectives.py:78"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:27"),
    "rms_norm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:12"),
}
# operations per element of the int8 quantize: |x|, max, x / s, rint, clamp
QUANT_OPS_PER_ELEMENT = 6
# of RMSNorm: square-add, times rsqrt, times gamma (the row's rsqrt apart)
RMS_OPS_PER_ELEMENT = 4
# of SwiGLU: negate, exp, add, divide, multiply
SWIGLU_OPS_PER_ELEMENT = 5
OPS_KERNELS = ("flash_prefill", "rms_norm", "swiglu")
INT8_REDUCE_KERNELS = ("quantize_int8_shards", "dequant_sum_quantize_int8",
                       "dequantize_int8_gathered")


# the serving path's attention kernels (B2 runs inside paged_decode's
# launches: the paged_decode/fold variant)
ATTENTION_KERNELS = ("paged_decode", "paged_prefill")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, replays: int = 7) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between CUDA events, the median over
    ``replays`` replays divided by ``reps``.  Replaying a graph keeps the
    wrappers' host work (checks, allocation, ctypes) out of the measured
    time, which for the small reduce kernel is longer than the kernel."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def call_ms(fn, iters: int = 20) -> float:
    """Median per-call time between CUDA events around one eager call,
    host work of the wrapper included."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(gen, lengths, ps, hkv, hd, dtype, mb=0):
    """Random pool holding lengths[b] tokens per row (whole pages filled:
    keys past a row's length are poison the masks must hide) and its block
    tables of width ``mb`` (default: one page more than the longest row),
    in shuffled page order."""
    import torch
    B = len(lengths)
    mb = mb or -(-max(max(lengths), 1) // ps) + 1
    n_pages = sum(-(-L // ps) for L in lengths) + 3
    k = torch.randn((n_pages + 1, ps, hkv, hd), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((n_pages + 1, ps, hkv, hd), generator=gen,
                    device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((B, mb), -1, dtype=torch.int32)
    for b, L in enumerate(lengths):
        for blk in range(-(-L // ps)):
            bt[b, blk] = perm.pop()
    return k, v, bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                         device="cuda")


def max_err(got, want, tol) -> float:
    """Max |got - want|; raises if any element is outside atol + rtol*|want|
    or not finite."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError("kernel output not finite")
        d = (g - w).abs()
        bad = d > tol["atol"] + tol["rtol"] * w.abs()
        if bad.any():
            raise AssertionError(f"{int(bad.sum())} elements out of "
                                 f"tolerance {tol}; max err {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def decode_case(gen, errs, lengths, ps, hq, hkv, hd, K, S, window,
                dtype_name, mb=0) -> int:
    """B1 (and B2 at S > 1) against the plain versions on one random pool:
    the span partials within ``TOL``, the dead-page skip bit-identical to the
    full walk, every span partial of a row with no key in its span (past the
    row's length, or wholly outside the window) exactly neutral (0, NEG_INF,
    0), and the whole wrapper against the plain pipeline.  Returns how many
    such neutral (request, span, row) partials the case held."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    dtype = getattr(torch, dtype_name)
    k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dtype, mb)
    B = len(lengths)
    q = torch.randn((B, K, hq, hd), generator=gen, device="cuda").to(dtype)
    group = hq // hkv
    gk = group * K
    qg = q.reshape(B, K, hkv, group, hd).permute(0, 2, 3, 1, 4).reshape(
        B, hkv, gk, hd)
    S = max(1, min(S, bt.shape[1]))
    got = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K, window=window,
                             kv_splits=S)
    want = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                    window=window, kv_splits=S)
    tol = TOL[dtype_name]
    errs["paged_decode"] = max(errs["paged_decode"], max_err(got, want, tol))
    walked = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K,
                                window=window, kv_splits=S,
                                guard_dead_pages=False)
    for a, b in zip(got, walked):
        if not torch.equal(a, b):
            raise AssertionError("dead-page skip is not bit-identical")
    # span s holds key positions [s * L, (s + 1) * L), L = pps * ps
    L = -(-bt.shape[1] // S) * ps
    pos = torch.arange(S * L, device="cuda").reshape(1, S, 1, L)
    ln = lens.long().reshape(B, 1, 1, 1)
    ok = pos < ln
    if window:
        qi = (torch.arange(gk, device="cuda") % K).reshape(1, 1, gk, 1)
        ok = ok & (pos > ln + qi - window)
    empty = (~ok.any(-1)).expand(B, S, gk)[:, None].expand(
        -1, hkv, -1, -1)                                      # (B,Hkv,S,gk)
    o, m, l = (t[empty] for t in got)
    if bool((o != 0).any()) or bool((l != 0).any()) or \
            bool((m != fd.NEG_INF).any()):
        raise AssertionError("a span partial with no key is not neutral")
    if S > 1:
        red = fd.decode_reduce(*got)
        red_plain = fd.decode_reduce_plain(*got)
        errs["decode_reduce"] = max(errs["decode_reduce"],
                                    max_err(red, red_plain, TOL["float32"]))
        # the fold inside the decode launch: the standalone reduce's bits,
        # whichever block of a tile arrived last
        folded = fd.decode_folded(qg, k, v, bt, lens, k_tokens=K,
                                  window=window, kv_splits=S)
        for a, b in zip(folded, red):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"the fold in the decode launch differs from the "
                    f"standalone reduce (gk {gk}, S {S}, {dtype_name})")
    # the whole wrapper (the fold included) against the plain pipeline
    o = fd.flash_decode(q, k, v, bt, lens, window=window, kv_splits=S)
    po, pm, pl = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                          window=window, kv_splits=S)
    if S > 1:
        po, pm, pl = fd.decode_reduce_plain(po, pm, pl)
    else:
        po, pm, pl = po[:, :, 0], pm[:, :, 0], pl[:, :, 0]
    unrow = lambda t, last: t.reshape(B, hkv, group, K, last).permute(
        0, 3, 1, 2, 4).reshape(B, K, hq, last)
    max_err(o, (unrow(po, hd), unrow(pm, 1), unrow(pl, 1)), tol)
    return int(empty.sum()) // hkv


def check_decode_edges(gen, errs) -> tuple:
    """B1's edges, bf16 and fp32: head dims 64 and 256, 80 (six idle lanes
    of sixteen per key), 20 (bf16: the synchronous loads; fp32: a lane's
    second 16-byte piece past hd) and 18 (rows off the 16-byte grid: the
    synchronous loads in both); page sizes 32 and 64; query rows 1, 12 (a
    ragged 4-row tile), 32, and 33, 40, 48 and 64 (past the 8 row tiles the
    kernel took until the limit was lifted), one of them on clustered grids;
    one request of 8192 tokens (MB 512) at S = 1 and S = 4 (clusters of
    blocks a span); a batch in which every span of one row is dead; a batch
    whose lengths are all 0.  At S > 1 every case also holds the fold inside
    the decode launch bit-equal to the standalone reduce.  Returns (cases,
    neutral span partials held)."""
    n = neutral = 0
    short = [1, 15, 16, 17, 100, 300, 0]
    for dtype_name in ("bfloat16", "float32"):
        cases = []
        for hd in (64, 80, 256, 20, 18):
            cases += [(short, 16, 8, 2, hd, 1, 4, 0),
                      (short, 16, 8, 2, hd, 2, 1, 37)]
        for ps in (32, 64):
            for S, window in ((1, 0), (4, 100)):
                cases.append(([1, 31, 32, 33, 500, 2047, 0], ps, 32, 8, 128,
                               1, S, window))
        # gk 1, 12, 32, then 33 (group 11, K 3), 40 (group 8, K 5: a
        # group-8 model's spec_k = 4 window), 48 and 64
        for hq, hkv, K, S, window in ((2, 2, 1, 4, 0), (8, 2, 3, 2, 20),
                                      (16, 2, 4, 2, 12), (16, 2, 4, 1, 0),
                                      (22, 2, 3, 4, 0), (16, 2, 5, 4, 30),
                                      (24, 2, 4, 1, 0), (32, 2, 4, 7, 0)):
            cases.append(([3, 17, 64, 130, 0], 16, hq, hkv, 128, K, S,
                          window))
        # 40 rows on short grids (clusters of blocks a span): one request
        # of 3000 tokens at S 2 and 4
        for S in (2, 4):
            cases.append(([3000], 16, 16, 2, 128, 5, S, 0))
        for S in (1, 4):
            cases.append(([8192], 16, 32, 8, 128, 1, S, 0, 512))
        cases += [([700, 0, 2030], 16, 32, 8, 128, 1, 4, 0),
                  ([5, 2000], 16, 32, 8, 128, 1, 4, 0),
                  ([0, 0, 0], 16, 32, 8, 128, 1, 4, 0),
                  ([0, 0], 16, 32, 8, 128, 1, 1, 100)]
        for case in cases:
            lengths, ps, hq, hkv, hd, K, S, window = case[:8]
            neutral += decode_case(gen, errs, lengths, ps, hq, hkv, hd, K, S,
                                   window, dtype_name, *case[8:])
            n += 1
    return n, neutral


def check_kernels(report):
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    from repro_torch.kernels import native
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"paged_decode": 0.0, "decode_reduce": 0.0, "paged_prefill": 0.0}

    def prefill_case(prefix_lens, offsets, Sq, ps, hq, hkv, hd, window,
                     dtype_name):
        """Returns how many rows of a resumed request (prefix > 0) the
        window left with no key: those, and every fresh row (prefix 0),
        must come back exactly neutral (0, NEG_INF, 0)."""
        dtype = getattr(torch, dtype_name)
        k, v, bt, lens = make_pool(gen, prefix_lens, ps, hkv, hd, dtype)
        q = torch.randn((len(prefix_lens), hq, Sq, hd), generator=gen,
                        device="cuda").to(dtype)
        qs = lens + torch.tensor(offsets, dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_paged(q, k, v, bt, lens, qs, window=window)
        want = fp.prefill_partial_plain(q, k, v, bt, lens, qs, window=window)
        errs["paged_prefill"] = max(errs["paged_prefill"],
                                    max_err(got, want, TOL[dtype_name]))
        # row i of request b attends no key iff its prefix is empty or the
        # window ends before it: q_start + i - window >= prefix_len - 1
        pos = qs.long()[:, None] + torch.arange(Sq, device="cuda")[None]
        empty = (lens.long()[:, None] == 0).expand(-1, Sq)
        if window:
            empty = empty | (pos - window >= lens.long()[:, None] - 1)
        o, m, l = (t[empty[:, None, :].expand(-1, hq, -1)] for t in got)
        if bool((o != 0).any()) or bool((l != 0).any()) or \
                bool((m != fd.NEG_INF).any()):
            raise AssertionError("a row with no key (fresh, or wholly "
                                 "outside the window) is not neutral")
        return int((empty & (lens.long()[:, None] > 0)).sum())

    main_lengths = [1, 15, 16, 17, 255, 256, 257, 1000, 2047, 2048]
    n = 0
    for dtype_name in ("bfloat16", "float32"):
        # (Hq, Hkv): qwen3-8b at tp=1, and one rank's heads at tp=2
        for hq, hkv in ((32, 8), (16, 4)):
            for S in (1, 4):
                for window in (0, 100):
                    decode_case(gen, errs, main_lengths, 16, hq, hkv, 128,
                                1, S, window, dtype_name)
                    n += 1
        for K, S, window in ((1, 1, 0), (2, 4, 12), (4, 2, 0)):
            decode_case(gen, errs, [1, 7, 8, 9, 22, 37, 0], 8, 4, 2, 16, K,
                        S, window, dtype_name)
            n += 1
        for window in (0, 100):
            # a 512-token grant at tp=1; one rank's 256-token ISO chunk
            # of a grant at tp=2
            for Sq, hq, hkv in ((512, 32, 8), (256, 16, 4)):
                prefill_case([0, 700, 2000], [0, 0, 256], Sq, 16, hq, hkv,
                             128, window, dtype_name)
                n += 1
        for window in (0, 5):
            prefill_case([0, 11, 24, 15], [0, 3, 0, 5], 10, 8, 4, 2, 16,
                         window, dtype_name)
            n += 1
    # the bf16 tile loop's edges: hd 64/80/256 (a padded width at 80), page
    # sizes 8/16/32 (a 64-key tile from 8/4/2 pages), group 1/2/4/8 (64/32/
    # 16/8 query rows per head), Sq 100 (a ragged last query block),
    # prefixes that are not multiples of 64, a fresh row; then a window that
    # leaves rows of resumed requests with no key, group 80 (80 rows: two
    # row blocks), and hd 20 (the synchronous loads past cp.async)
    n_tc = 0
    for hd in (64, 80, 256):
        for ps in (8, 16, 32):
            for group in (1, 2, 4, 8):
                prefill_case([0, 37, 130, 200], [0, 3, 0, 50], 100, ps,
                             2 * group, 2, hd, 0, "bfloat16")
                n_tc += 1
    emptied = 0
    for hd, ps, group in ((128, 16, 4), (80, 8, 1), (64, 32, 8)):
        emptied += prefill_case([0, 37, 130, 200], [0, 3, 0, 50], 100, ps,
                                2 * group, 2, hd, 20, "bfloat16")
        n_tc += 1
    if emptied <= 0:
        raise AssertionError("no windowed row of a resumed request was left "
                             "with no key")
    prefill_case([0, 70, 129], [0, 0, 7], 10, 16, 80, 1, 64, 0, "bfloat16")
    prefill_case([0, 70, 129], [0, 0, 7], 37, 16, 8, 2, 20, 9, "bfloat16")
    n_tc += 2
    n_dec, neutral = check_decode_edges(gen, errs)
    torch.cuda.synchronize()
    log(f"[kernels] {n + n_tc + n_dec} cases within tolerance {TOL} ({n_tc} "
        f"of them the bf16 tile loop's edges: {emptied} rows of resumed "
        f"requests wholly outside the window, neutral; {n_dec} the decode "
        f"kernel's edges: hd 64/80/256/20/18, ps 32/64, gk 1/12/32/33/40/"
        f"48/64, 8192 and 3000 tokens on clustered grids, dead rows, all "
        f"lengths 0, {neutral} span partials with no key, neutral); "
        f"dead-page skip bit-identical; at S > 1 the fold in the decode "
        f"launch bit-equal to the standalone reduce; max abs err {errs}")
    check_fold_arrivals(gen)
    errs["quantize_int8"] = check_quantize(gen)
    errs.update(check_int8_reduce(gen))
    errs.update(check_ops_kernels(gen))
    report["errs"] = errs


def check_quantize(gen) -> float:
    """The int8 kernel against its plain version: q and scale must be equal
    (``torch.equal``), so the max abs error reported is 0."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 96, 100, 256, 1024, 2048, 2056, 4096):
            for rows in (1, 37):
                x = (torch.randn((rows, d), generator=gen, device="cuda")
                     * 5).to(dtype)
                x[0] = 0                                 # floor scale
                # an element offset: no 16-byte loads, the scalar path
                shifted = torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:]
                for xx in (x, shifted.view(rows, d)):
                    got = q8.quantize_int8(xx)
                    want = q8.quantize_int8_plain(xx)
                    for g, w in zip(got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"quantize_int8 {dtype} rows={rows} d={d}: "
                                f"kernel differs from the plain version")
                    n += 1
    ties = torch.zeros((3, 8), device="cuda")
    ties[0] = torch.tensor([127, 2.5, 3.5, -0.5, -1.5, 0.5, -126.5, 126.5])
    for dtype in (torch.bfloat16, torch.float32):
        q, s = q8.quantize_int8(ties.to(dtype))
        qp, sp = q8.quantize_int8_plain(ties.to(dtype))
        if not (torch.equal(q, qp) and torch.equal(s, sp)) or \
                q[0].tolist() != [127, 2, 4, 0, -2, 0, -126, 126]:
            raise AssertionError(f"quantize_int8 ties: {q[0].tolist()}")
        n += 1
    torch.cuda.synchronize()
    log(f"[kernels] quantize_int8: {n} cases bit-equal to the plain version "
        f"(bf16/fp32, d 64..4096, vector and scalar paths, zero row, .5 "
        f"ties round half to even)")
    return 0.0


def check_fold_arrivals(gen) -> None:
    """The fold's arrival counters are back at 0 after three launches in a
    row on the stream (no wait between them) and after the replays of a
    CUDA graph that captured three more, and every launch gives the same
    bits: the counter of a tile is reset by the block that folds it."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    k, v, bt, lens = make_pool(gen, [700, 1200, 1700, 2030], 16, 8, 128,
                               torch.bfloat16, mb=128)
    qg = torch.randn((4, 8, 40, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    run = lambda: fd.decode_folded(qg, k, v, bt, lens, k_tokens=5, window=0,
                                   kv_splits=4)
    want = run()
    outs = [run() for _ in range(3)]
    torch.cuda.synchronize()
    counters = fd._ARRIVALS[qg.device]
    if int(counters.abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after three "
                             "launches in a row")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run() for _ in range(3)]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    if int(fd._ARRIVALS[qg.device].abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after a CUDA-graph "
                             "replay")
    for got in outs + captured:
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError("a repeated fused decode launch gave "
                                     "other bits")
    log(f"[kernels] fold arrivals: {counters.numel()} counters at 0 after 3 "
        f"launches in a row and after 2 replays of a graph of 3 (gk 40, S 4, "
        f"32 tiles a launch); every launch the same bits")


def check_int8_reduce(gen) -> dict:
    """The int8 all-reduce's three kernels against their plain versions,
    EQUAL (``torch.equal``): the shards quantize over bf16/fp32 rows at tp
    2 and 4 (vector and scalar paths), the rank sum and re-quantize over
    random exchanges at tp 2 and 4 (d 2048, 256, 18, and an unaligned
    base), the gathered dequantize into bf16 and fp32.  Returns each one's
    max abs error (0)."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    n = 0

    def equal(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version at {tuple(w.shape)}")

    for tp in (2, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for shape in ((4, 4096), (512, 4096), (2, 1, 4096), (3, 72),
                          (5, 4 * 18)):
                x = (torch.randn(shape, generator=gen, device="cuda")
                     * 5).to(dtype)
                x.reshape(-1, shape[-1])[0] = 0          # floor scales
                equal("quantize_int8_shards", q8.quantize_int8_shards(x, tp),
                      q8.quantize_int8_shards_plain(x, tp))
                n += 1
        for R, d in ((4, 2048), (512, 2048), (3, 256), (5, 18)):
            q = torch.randint(-127, 128, (tp, R, d), generator=gen,
                              device="cuda").to(torch.int8)
            s = torch.rand((tp, R, 1), generator=gen, device="cuda") + 1e-3
            q[:, 0] = 0                                   # an all-zero sum
            flat = torch.empty(q.numel() + 1, dtype=torch.int8,
                               device="cuda")
            flat[1:] = q.reshape(-1)
            shifted = flat[1:].view(q.shape)              # the scalar path
            for qq in (q, shifted):
                equal("dequant_sum_quantize_int8",
                      q8.dequant_sum_quantize_int8(qq, s),
                      q8.dequant_sum_quantize_int8_plain(qq, s))
                for dtype in (torch.bfloat16, torch.float32):
                    equal("dequantize_int8_gathered",
                          q8.dequantize_int8_gathered(qq, s, dtype),
                          q8.dequantize_int8_gathered_plain(qq, s, dtype))
                n += 3
    torch.cuda.synchronize()
    log(f"[kernels] int8 reduce: quantize_int8_shards, "
        f"dequant_sum_quantize_int8, dequantize_int8_gathered: {n} cases "
        f"bit-equal to their plain versions (tp 2 and 4, bf16/fp32, vector "
        f"and scalar paths, zero rows)")
    return {k: 0.0 for k in INT8_REDUCE_KERNELS}


def check_ops_kernels(gen) -> dict:
    """The flash-prefill, RMSNorm and SwiGLU kernels against their plain
    versions; returns each one's max abs error."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import rmsnorm, swiglu
    errs = {k: 0.0 for k in OPS_KERNELS}
    n = 0

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def shifted(x):
        """x's values one element past a 16-byte boundary: the scalar path."""
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    def flash_case(B, hq, hkv, Sq, Sk, hd, dtype, q_start, causal=True,
                   window=0, empty_from=None):
        q, k, v = (randn(s, dtype) for s in ((B, hq, Sq, hd), (B, hkv, Sk, hd),
                                              (B, hkv, Sk, hd)))
        got = fp.flash_attention(q, k, v, q_start=q_start, causal=causal,
                                 window=window)
        want = fp.flash_attention_plain(q, k, v, q_start=q_start,
                                        causal=causal, window=window)
        if got.dtype != dtype:
            raise AssertionError(f"flash_attention returned {got.dtype}")
        errs["flash_prefill"] = max(errs["flash_prefill"], max_err(
            [got.float()], [want.float()], TOL[str(dtype)[6:]]))
        if empty_from is not None and \
                float(got[:, :, empty_from:].abs().max()) != 0.0:
            raise AssertionError("flash_attention: a row with no key is not 0")

    for dtype in (torch.bfloat16, torch.float32):
        # the CPU tests' shapes: MHA, GQA with a prefix, MQA ragged
        for B, hq, hkv, Sq, Sk, hd in ((1, 2, 2, 16, 16, 32),
                                       (2, 4, 2, 48, 80, 64),
                                       (1, 8, 1, 33, 70, 128)):
            flash_case(B, hq, hkv, Sq, Sk, hd, dtype, Sk - Sq)
            n += 1
        for window, causal in ((8, True), (24, True), (24, False),
                               (0, False)):
            flash_case(1, 2, 2, 32, 64, 32, dtype, 32, causal, window)
            n += 1
        # rows 3.. of 8 attend no key (q_start + i >= Sk - 1 + window)
        flash_case(1, 4, 2, 8, 16, 16, dtype, 16, window=4, empty_from=3)
        # full width, tp=1 and one tp=2 rank: the second ISO chunk, the
        # whole prompt, ragged lengths with a window; head_dim limits
        for hq, hkv in ((32, 8), (16, 4)):
            flash_case(1, hq, hkv, 1024, 2048, 128, dtype, 1024)
            flash_case(1, hq, hkv, 2048, 2048, 128, dtype, 0)
            flash_case(2, hq, hkv, 1000, 1500, 128, dtype, 500, window=256)
            n += 3
        for hd in (80, 200, 256):
            flash_case(1, 4, 2, 100, 130, hd, dtype, 30)
            n += 1
        # hd 20: rows of no whole 16-byte chunk, the synchronous loads
        flash_case(2, 4, 2, 70, 90, 20, dtype, 20, window=33)
        n += 1

        for shape, gdt in (((5, 128), torch.float32),
                           ((2, 33, 256), torch.float32),
                           ((2048, 4096), torch.float32),
                           ((2048, 4096), torch.bfloat16),
                           ((3, 100), torch.bfloat16),
                           ((37, 4104), torch.float32)):
            x = randn(shape, dtype)
            gamma = randn(shape[-1:], gdt)
            for xx in (x, shifted(x)):
                got = rmsnorm.rms_norm(xx, gamma)
                want = rmsnorm.rms_norm_plain(xx, gamma)
                errs["rms_norm"] = max(errs["rms_norm"], max_err(
                    [got.float()], [want.float()], TOL[str(dtype)[6:]]))
                n += 1
        for shape in ((4, 512), (2, 17, 300), (2048, 12288), (2048, 6144),
                      (3, 77)):
            g, u = randn(shape, dtype), randn(shape, dtype)
            for gg, uu in ((g, u), (shifted(g), u)):
                got = swiglu.swiglu(gg, uu)
                want = swiglu.swiglu_plain(gg, uu)
                errs["swiglu"] = max(errs["swiglu"], max_err(
                    [got.float()], [want.float()], TOL[str(dtype)[6:]]))
                n += 1
    torch.cuda.synchronize()
    log(f"[kernels] flash_prefill / rms_norm / swiglu: {n} cases within "
        f"tolerance of their plain versions (bf16/fp32; full width and the "
        f"CPU tests' shapes; rows with no key 0; scalar paths); max abs err "
        f"{errs}")
    return errs


def time_kernels(report):
    """Time each kernel and its plain version at the shapes its path gives
    it: decode B=4 rows of 700/1200/1700/2030 resident tokens (MB=128) with
    S=4 spans, as the engine splits walks past 16 pages, folded in the
    launch as the serving path runs it (and at one tp=2 rank's heads, and
    one request of 8192 tokens, MB=512), and the walk alone into its span
    partials; the standalone reduce of those partials; a 512-token resumed
    chunk over a 1024-token prefix, and the serving path's 256-token ISO
    chunk over it; the int8 quantize at the tp=2 decode and prefill reduce
    shapes; the int8 all-reduce's three kernels, and its local part against
    B7 composed with PyTorch ops; the ops path's flash prefill, RMSNorm and
    SwiGLU (phase 7), each beside the one PyTorch call that computes the
    same function where there is one.  Then the per-launch floor, each
    row's gap to its bound and to max(bound, floor), what the fold adds to
    the decode launch, and the int8 reduce's local time against B7's with
    PyTorch ops."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    ps, hq, hkv, hd, S = 16, 32, 8, 128, 4
    paged = "no single PyTorch call computes paged attention over block tables"
    dec, dec_spans, (parts, red_bytes, red_ops, red_shape) = \
        decode_timing_case(gen, [700, 1200, 1700, 2030], hq, hkv, S, 128,
                           paged)
    red = lambda: fd.decode_reduce(*parts)
    red_plain = lambda: fd.decode_reduce_plain(*parts)
    prefix = 1024
    pk, pv, pbt, plens = make_pool(gen, [prefix], ps, hkv, hd, dt, mb=128)

    def p_case(Sq, q_off, what):
        q = torch.randn((1, hq, Sq, hd), generator=gen, device="cuda").to(dt)
        qs = plens + q_off
        nbytes = (q.numel() * 2 + pbt.numel() * 4 + 8
                  + 2 * prefix * hkv * hd * 2 + hq * Sq * (hd + 2) * 4)
        return (lambda: fp.flash_prefill_paged(q, pk, pv, pbt, plens, qs),
                lambda: fp.prefill_partial_plain(q, pk, pv, pbt, plens, qs),
                nbytes, 4 * Sq * prefix * hq * hd, "bfloat16",
                f"B=1 Sq={Sq} prefix={prefix} Hq={hq} Hkv={hkv} hd={hd} "
                f"ps={ps} MB=128 bf16 ({what})", paged)

    # the int8 reduces of qwen3-8b at tp=2 (d = 4096 in 2 shards of 2048):
    # a decode half of 2 requests, (2, 1, 4096) bf16 -> (4, 2048) rows,
    # and its fp32 re-quantize, (2, 2048); a 256-token ISO chunk,
    # (1, 256, 4096) -> (512, 2048) bf16, and its (256, 2048) re-quantize
    from repro_torch.kernels import int8_quant as q8
    xq = {"decode": torch.randn((4, 2048), generator=gen,
                                device="cuda").to(dt),
          "decode_requant": torch.randn((2, 2048), generator=gen,
                                        device="cuda"),
          "prefill": torch.randn((512, 2048), generator=gen,
                                 device="cuda").to(dt),
          "prefill_requant": torch.randn((256, 2048), generator=gen,
                                         device="cuda")}

    def q_bytes(x):
        return x.numel() * x.element_size() + x.numel() + x.shape[0] * 4

    def q_case(key, what):
        x = xq[key]
        return (lambda: q8.quantize_int8(x), lambda: q8.quantize_int8_plain(x),
                q_bytes(x), QUANT_OPS_PER_ELEMENT * x.numel(), "float32",
                f"rows={x.shape[0]} d={x.shape[1]} "
                f"{str(x.dtype).replace('torch.', '')} ({what})",
                "no single PyTorch call computes per-row abs-max int8 with "
                "its scale")

    # the ops path's shapes (phase 7): the second 1024-token ISO chunk of a
    # 2048-token prompt over its whole prefix (and the whole prompt in one
    # call), RMSNorm (2048, 4096) with an fp32 gamma, SwiGLU (2048, 12288)
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_prefill import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rms_norm_plain
    from repro_torch.kernels.swiglu import swiglu_plain
    fk = torch.randn((1, hkv, 2048, hd), generator=gen, device="cuda").to(dt)
    fv = torch.randn((1, hkv, 2048, hd), generator=gen, device="cuda").to(dt)
    fq = torch.randn((1, hq, 2048, hd), generator=gen, device="cuda").to(dt)

    def f_case(q0, what):
        q = fq[:, :, q0:].contiguous()
        Sq, Sk = q.shape[2], fk.shape[2]
        # the offset-causal mask; the pairs it keeps are this run's work
        mask = (torch.arange(Sk, device="cuda")[None, :]
                <= q0 + torch.arange(Sq, device="cuda")[:, None])
        pairs = int(mask.sum()) * hq
        nbytes = 2 * (q.numel() * 2 + fk.numel() + fv.numel())
        return (lambda: ops.flash_attention(q, fk, fv, q_start=q0),
                lambda: flash_attention_plain(q, fk, fv, q_start=q0),
                nbytes, 4 * hd * pairs, "bfloat16",
                f"B=1 Sq={Sq} Sk={Sk} q_start={q0} Hq={hq} Hkv={hkv} "
                f"hd={hd} bf16 ({what})",
                lambda: F.scaled_dot_product_attention(
                    q, fk, fv, attn_mask=mask, enable_gqa=True))

    xr = torch.randn((2048, 4096), generator=gen, device="cuda").to(dt)
    gr = torch.randn((4096,), generator=gen, device="cuda")
    gs = torch.randn((2048, 12288), generator=gen, device="cuda").to(dt)
    us = torch.randn((2048, 12288), generator=gen, device="cuda").to(dt)

    cases = {
        "flash_prefill": f_case(1024, "second ISO chunk over its prefix"),
        "flash_prefill/full": f_case(0, "the whole prompt in one call"),
        "rms_norm": (lambda: ops.rms_norm(xr, gr),
                     lambda: rms_norm_plain(xr, gr),
                     2 * xr.numel() * 2 + gr.numel() * 4,
                     RMS_OPS_PER_ELEMENT * xr.numel(), "float32",
                     "rows=2048 d=4096 bf16, fp32 gamma",
                     lambda: F.rms_norm(xr, (4096,), gr, 1e-6)),
        "swiglu": (lambda: ops.swiglu(gs, us), lambda: swiglu_plain(gs, us),
                   3 * gs.numel() * 2, SWIGLU_OPS_PER_ELEMENT * gs.numel(),
                   "float32", "rows=2048 F=12288 bf16",
                   "no single PyTorch call computes silu(gate) * up"),
        # the decode shape, which most launches take, is the kernel line's
        "quantize_int8": q_case("decode", "tp=2 decode half of 2 requests"),
        "quantize_int8/decode_requant": q_case(
            "decode_requant", "its re-quantize of the reduced slice"),
        "quantize_int8/prefill": q_case(
            "prefill", "tp=2 256-token ISO chunk of a prefill grant"),
        "quantize_int8/prefill_requant": q_case(
            "prefill_requant", "its re-quantize of the reduced slice"),
        # the earlier PRs' shape is the kernel line's, now with the spans
        # folded in the launch (the walk alone beside it); one request of
        # 8192 tokens (a short grid: 32 spans for 132 SMs); one tp=2 rank's
        # heads
        "paged_decode": dec,
        "paged_decode/spans": dec_spans,
        "paged_decode/long": decode_timing_case(gen, [8192], hq, hkv, S, 512,
                                                paged)[0],
        "paged_decode/tp2": decode_timing_case(
            gen, [700, 1200, 1700, 2030], hq // 2, hkv // 2, S, 128,
            paged)[0],
        # B2 as a launch of its own, over the same walk's partials
        "decode_reduce": (red, red_plain, red_bytes, red_ops, "float32",
                          red_shape, paged),
        # the earlier PRs' shape, kept for continuity, is the kernel line's
        "paged_prefill": p_case(512, 512, "a 512-token resumed chunk"),
        "paged_prefill/iso_chunk": p_case(
            256, 256, "the second 256-token ISO chunk of a resumed 512-token "
            "grant, the serving path's shape"),
    }
    cases.update(int8_reduce_cases(
        gen, "no single PyTorch call computes a step of the int8 "
        "all-reduce"))
    # each case ends in its library call, or why there is none
    timing = {}
    for name, (fn, plain, nbytes, n_ops, kind, shape, library) \
            in cases.items():
        ms = time_ms(fn)
        plain_ms = None if plain is None else time_ms(plain, reps=5)
        library_ms = None if isinstance(library, str) \
            else time_ms(library, reps=5)
        eager_ms = call_ms(fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_FLOPS[kind] * 1e3
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations", shape=shape,
                            bytes=nbytes, ops=n_ops, eager_ms=eager_ms)
        lib = (f"library_ms none: {library}" if library_ms is None else
               f"library {library_ms:.4f} ms, {ms / library_ms:.2f}x it")
        plain_txt = "none" if plain_ms is None else f"{plain_ms:.4f} ms"
        log(f"[time] {name}: {ms:.4f} ms on the device, {eager_ms:.4f} ms "
            f"per eager call with the wrapper's host work (plain "
            f"{plain_txt}, bound "
            f"{max(t_bytes, t_ops):.5f} ms by {timing[name]['bound_by']}, "
            f"{lib}) at {shape}")
    # the device time of one trivial launch through the same graph replay:
    # no kernel can take less, whatever its bound
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(one.zero_)
    log(f"[time] per-launch floor (one zero_() of a 1-element tensor through "
        f"the same CUDA-graph replay; no kernel's time): {floor_ms:.5f} ms")
    for name, t in timing.items():
        log(f"[time] {name}: ms - bound {t['ms'] - t['bound_ms']:.5f}, ms - "
            f"max(bound, floor) {t['ms'] - max(t['bound_ms'], floor_ms):.5f}")
    fold_ms = timing["paged_decode"]["ms"] - timing["paged_decode/spans"]["ms"]
    log(f"[time] the fold inside the decode launch costs {fold_ms:.5f} ms "
        f"(paged_decode - paged_decode/spans); the two launches it replaces "
        f"took {timing['paged_decode/spans']['ms']:.5f} + "
        f"{timing['decode_reduce']['ms']:.5f} ms")
    for name in ("decode", "prefill"):
        new_ms = timing[f"int8_reduce/{name}"]["ms"]
        old_ms = timing[f"int8_reduce/{name}/b7_ops"]["ms"]
        log(f"[time] int8 reduce local part at the {name} shape: three "
            f"kernels {new_ms:.5f} ms, B7 with PyTorch ops in eleven launches "
            f"{old_ms:.5f} ms ({old_ms / new_ms:.2f}x)")
    report["timing"] = timing
    report["floor_ms"] = floor_ms


def decode_timing_case(gen, lengths, hq, hkv, S, mb, paged):
    """B1's timing cases at ``lengths`` resident tokens (hd 128, ps 16, K 1,
    bf16, table width ``mb``, ``S`` > 1 spans), each (fn, plain, bytes, ops,
    kind, shape, library): the serving path's form, the walk with its S span
    partials folded inside the launch; the walk alone into its S partials
    (the launch before the fold moved in); then (its partials, bytes, ops
    and shape of their reduce).  Bytes: q, the block tables, lengths, every
    resident page of K and V once, and the output (the folded state, or the
    partials); operations: 4 * hd per (query row, key)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    ps, hd, K, dt = 16, 128, 1, torch.bfloat16
    gk = hq // hkv * K
    B = len(lengths)
    k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dt, mb=mb)
    qg = torch.randn((B, hkv, gk, hd), generator=gen, device="cuda").to(dt)
    kw = dict(k_tokens=K, window=0, kv_splits=S)
    dec = lambda: fd.decode_partials(qg, k, v, bt, lens, **kw)
    dec_plain = lambda: fd.decode_partials_plain(qg, k, v, bt, lens, **kw)
    fold = lambda: fd.decode_folded(qg, k, v, bt, lens, **kw)
    fold_plain = lambda: fd.decode_reduce_plain(*dec_plain())
    walked_pages = sum(-(-L // ps) for L in lengths)
    in_bytes = (qg.numel() * 2 + bt.numel() * 4 + B * 4
                + 2 * walked_pages * ps * hkv * hd * 2)
    part_bytes = B * hkv * S * gk * (hd + 2) * 4
    fold_bytes = B * hkv * gk * (hd + 2) * 4
    n_ops = 4 * sum(lengths) * hq * hd
    shape = (f"B={B} L={lengths} Hq={hq} Hkv={hkv} hd={hd} ps={ps} MB={mb} "
             f"S={S} bf16")
    return ((fold, fold_plain, in_bytes + fold_bytes, n_ops, "bfloat16",
             shape + ", spans folded in the launch", paged),
            (dec, dec_plain, in_bytes + part_bytes, n_ops, "bfloat16",
             shape + ", the S span partials", paged),
            (dec(), part_bytes + fold_bytes, 4 * B * hkv * S * gk * hd,
             f"B={B} Hkv={hkv} S={S} gk={gk} hd={hd} fp32"))


def int8_reduce_cases(gen, hint):
    """Timing cases of the int8 all-reduce's local part at qwen3-8b's tp=2
    shapes, each (fn, plain, bytes, ops, kind, shape, library): its three
    kernels at the decode shape, and at (4, 4096) (a decode batch) and
    (512, 4096) (a prefill grant) one reduce's local steps as this port
    runs them (three launches) and as the composition of B7 with PyTorch
    ops that they replace (eleven).  The all-to-all and the all-gather are
    left out: each rank's own shards stand in for what it would receive.
    Bytes: each step's inputs read once and outputs written once."""
    import torch
    from repro_torch.kernels import int8_quant as q8
    tp, dt = 2, torch.bfloat16

    def three(x):
        q, s = q8.quantize_int8_shards(x, tp)
        q8.dequant_sum_quantize_int8(q, s)
        return q8.dequantize_int8_gathered(q, s, x.dtype)

    def three_plain(x):
        q, s = q8.quantize_int8_shards_plain(x, tp)
        q8.dequant_sum_quantize_int8_plain(q, s)
        return q8.dequantize_int8_gathered_plain(q, s, x.dtype)

    def eleven(x):
        """The steps as B7 and PyTorch ops: B7 on the shards, two copies,
        dequantize (2) and sum, B7 again, dequantize (2), a copy back and
        the cast."""
        d = x.shape[-1] // tp
        q, s = q8.quantize_int8(x.reshape(*x.shape[:-1], tp, d))
        q, s = q.movedim(-2, 0).contiguous(), s.movedim(-2, 0).contiguous()
        part = q8.dequantize_int8(q, s).sum(dim=0)
        q8.quantize_int8(part)
        out = q8.dequantize_int8(q, s).movedim(0, -2)
        return out.reshape(x.shape).to(x.dtype)

    def step_bytes(R, D):
        d = D // tp
        shards = R * D * 2 + R * D + tp * R * 4
        rank_sum = R * D + tp * R * 4 + R * d + R * 4
        gathered = R * D + tp * R * 4 + R * D * 2
        return shards, rank_sum, gathered

    cases = {}
    xd = torch.randn((4, 4096), generator=gen, device="cuda").to(dt)
    qd, sd = q8.quantize_int8_shards(xd, tp)
    b = step_bytes(4, 4096)
    shape = "x (4, 4096) bf16 at tp=2"
    cases["quantize_int8_shards"] = (
        lambda: q8.quantize_int8_shards(xd, tp),
        lambda: q8.quantize_int8_shards_plain(xd, tp), b[0],
        QUANT_OPS_PER_ELEMENT * xd.numel(), "float32", shape, hint)
    cases["dequant_sum_quantize_int8"] = (
        lambda: q8.dequant_sum_quantize_int8(qd, sd),
        lambda: q8.dequant_sum_quantize_int8_plain(qd, sd), b[1],
        (2 * tp + QUANT_OPS_PER_ELEMENT) * xd.numel() // tp, "float32",
        "q (2, 4, 2048) int8, s (2, 4, 1) at tp=2", hint)
    cases["dequantize_int8_gathered"] = (
        lambda: q8.dequantize_int8_gathered(qd, sd, dt),
        lambda: q8.dequantize_int8_gathered_plain(qd, sd, dt), b[2],
        2 * xd.numel(), "float32", "q (2, 4, 2048) int8 -> (4, 4096) bf16",
        hint)
    for name, R in (("decode", 4), ("prefill", 512)):
        x = torch.randn((R, 4096), generator=gen, device="cuda").to(dt)
        n_ops = (QUANT_OPS_PER_ELEMENT + 2 * tp + QUANT_OPS_PER_ELEMENT / tp
                 + 2) * x.numel()
        cases[f"int8_reduce/{name}"] = (
            lambda x=x: three(x), lambda x=x: three_plain(x),
            sum(step_bytes(R, 4096)), int(n_ops), "float32",
            f"x ({R}, 4096) bf16 at tp=2, three kernels", hint)
        cases[f"int8_reduce/{name}/b7_ops"] = (
            lambda x=x: eleven(x), None, sum(step_bytes(R, 4096)),
            int(n_ops), "float32",
            f"x ({R}, 4096) bf16 at tp=2, eleven launches (B7 "
            f"twice, nine PyTorch ops)", hint)
    return cases


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def serve_pass(eng, prompts, label: str, card: str) -> dict:
    """Serve ``prompts`` (32 greedy tokens each) on ``eng`` from zeroed
    metrics and launch counts; check that every request completed, every
    page came back and the attention kernels launched; print the pass."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.serving import Request, paged_engine
    from repro_torch.serving.requests import SamplingParams

    eng.metrics = dict.fromkeys(paged_engine.METRIC_KEYS, 0)
    eng.decode_splits = {}
    rids = [eng.add_request(Request(
        prompt=p.copy(), sampling=SamplingParams(max_new_tokens=32,
                                                 eos_id=-1)))
        for p in prompts]
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    outs = eng.run_until_complete()
    wall = time.perf_counter() - t0
    m = dict(eng.metrics)
    res = dict(tokens=[outs.get(r) for r in rids], m=m, wall=wall,
               launches=dict(native.LAUNCHES),
               variants=dict(native.VARIANTS),
               splits=dict(eng.decode_splits))
    if any(t is None or len(t) != 32 for t in res["tokens"]):
        raise AssertionError(f"{label}: not every request completed: {m}")
    if eng.alloc.free_pages != eng.alloc.num_pages:
        raise AssertionError(f"{label}: pages leaked")
    for name in ATTENTION_KERNELS:
        if res["launches"][name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched on "
                                 f"the main path: {res['launches']}")
    if m["resumed_grants"] <= 0:
        raise AssertionError(f"{label}: no resumed grant ran")
    log(f"[serve] {label}: prefill {m['prefill_tokens']} tok in "
        f"{m['prefill_s']:.3f}s = {m['prefill_tokens'] / m['prefill_s']:.0f} "
        f"tok/s ({m['prefill_calls']} calls, {m['resumed_grants']} resumed); "
        f"decode {1e3 * m['decode_s'] / m['decode_calls']:.2f} ms/step over "
        f"{m['decode_calls']} steps; host dispatch share (host time until the "
        f"calls return, of the fenced time): prefill "
        f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
        f"{m['decode_dispatch_s'] / m['decode_s']:.3f}; host "
        f"{1e3 * m['decode_dispatch_s'] / m['decode_calls']:.3f} ms a decode "
        f"step; wall {wall:.1f}s; preemptions {m['preemptions']} [{card}]")
    return res


def device_activity(prof, skip: str = None) -> dict:
    """From a ``torch.profiler`` trace with CUDA activities: the device
    intervals (kernels, copies, fills) whose names do not start with
    ``skip``, the union of their time, the span from the first start to the
    last end, and the time by name (ms)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not (skip and e.name.startswith(skip))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, -math.inf
    for a, b in spans:                        # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    return dict(n=len(spans), busy_ms=busy / 1e3,
                span_ms=(end - spans[0][0]) / 1e3 if spans else 0.0,
                by_name=sorted(by_name.items(), key=lambda kv: -kv[1][1]))


def log_top(label: str, act: dict, per: int, card: str) -> None:
    """The eight names that took the most device time, per step."""
    total = sum(t for _, (_, t) in act["by_name"])
    log(f"[serve] {label}: {act['n'] / per:.0f} device intervals and "
        f"{total / per:.3f} ms of device time a step; by name, ms a step "
        f"(launches a step) [{card}]:")
    for name, (n, t) in act["by_name"][:8]:
        log(f"    {t / per:8.3f} ({n / per:5.0f})  {name[:90]}")


def decode_idle_share(eng, prompts, card: str) -> None:
    """The device's idle share over ten decode steps of ``eng`` (through the
    graphs the trace captured).  Four of the trace's requests are
    prefilled; then ten decode steps run with CUDA events from before each
    call's staging to after its replay, and ten more the same way under
    ``torch.profiler`` with CUDA activities.  Once those requests are done,
    four more are prefilled under the profiler (where the device time of a
    step with grants goes): the untraced steps run before any tracing.

    Untraced, the device can be busy only inside those windows or while it
    copies the logits back, so one minus (the windows' time plus the traced
    logits copies) over the wall is a lower bound on the idle share.  The
    gaps inside a graph show only in the trace, which may stretch the
    kernels too: one minus the traced device time (the union of the
    intervals) over the untraced wall is the idle share if tracing leaves
    the kernels' time alone.  It does not if the traced device time outside
    the logits copies exceeds the untraced windows' time, and the script
    prints which holds; beside them, the traced steps' own idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, paged_engine
    from repro_torch.serving.requests import SamplingParams

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prefill_four() -> int:
        """Add four requests and step until their prompts are resident;
        returns the steps taken."""
        for p in prompts[:4]:
            eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
                max_new_tokens=32, eos_id=-1)))
        steps = 0
        while eng.scheduler.waiting or any(
                s is not None and s.prefilled < sum(s.chunk_plan)
                for s in eng.slots):
            eng.step()
            steps += 1
        return steps

    prefill_four()
    graphs = eng.graphs
    windows = []
    stage = paged_engine.StepClosure.stage
    call = paged_engine.StepClosure.__call__

    def timed_stage(self, **host):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        windows.append([a, None])
        stage(self, **host)

    def timed_call(self):
        out = call(self)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        windows[-1][1] = b
        return out

    def ten_steps():
        del windows[:]
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        wall = time.perf_counter() - t0
        if eng.graphs != graphs or len(windows) != 10:
            raise AssertionError(f"ten decode steps made {len(windows)} "
                                 f"calls and {eng.graphs - graphs} captures")
        return 1e3 * wall, sum(a.elapsed_time(b) for a, b in windows)

    paged_engine.StepClosure.stage = timed_stage
    paged_engine.StepClosure.__call__ = timed_call
    try:
        wall, inside = ten_steps()
        with profile(activities=acts) as prof:
            traced_wall, traced_inside = ten_steps()
    finally:
        paged_engine.StepClosure.stage = stage
        paged_engine.StepClosure.__call__ = call
    act = device_activity(prof)

    def drain():             # not run_until_complete, which serve_ab.py times
        while any(s is not None for s in eng.slots):
            eng.step()

    drain()
    grants = eng.metrics["prefill_calls"]
    with profile(activities=acts) as prefill_prof:
        steps = prefill_four()
    log_top(f"{steps} steps with {eng.metrics['prefill_calls'] - grants} "
            f"grants", device_activity(prefill_prof), steps, card)
    drain()
    log(f"[serve] ten graphed decode steps: {wall / 10:.3f} ms a step "
        f"untraced, {traced_wall / 10:.3f} traced; staging and replay "
        f"windows (CUDA events) {inside / 10:.3f} ms a step untraced, "
        f"{traced_inside / 10:.3f} traced [{card}]")
    if not act["n"]:
        log("[serve] torch.profiler saw no device activity: the idle share "
            "is not measured")
        return
    copies = act["busy_ms"] - device_activity(prof, "Memcpy DtoH")["busy_ms"]
    kernels = act["busy_ms"] - copies
    holds = kernels <= inside
    log(f"[serve] device idle share over ten graphed decode steps: at least "
        f"{1 - (inside + copies) / wall:.4f} (untraced windows "
        f"{inside:.3f} ms + traced logits copies {copies:.3f} ms over the "
        f"untraced wall {wall:.3f} ms); {1 - act['busy_ms'] / wall:.4f} if "
        f"tracing leaves the kernels' time alone (traced device time "
        f"{act['busy_ms']:.3f} ms over the untraced wall); the traced device "
        f"time outside the logits copies, {kernels:.3f} ms, "
        + ("fits within the untraced windows' time, as it must if so" if holds
           else f"exceeds the untraced windows' {inside:.3f} ms: tracing "
                f"stretched the kernels, and the second figure is low")
        + f"; the traced steps' own: {1 - act['busy_ms'] / act['span_ms']:.4f}"
        f" of a {act['span_ms']:.3f} ms span [{card}]")
    log_top("ten graphed decode steps", act, 10, card)


def serve_full(report, card: str):
    """Phase 3: the six requests on an eager engine (``cuda_graphs=False``),
    then on a graphed one, a capture pass and a timed pass; the graphed
    tokens must equal the eager ones."""
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine, paged_engine

    cfg = get_model_config("qwen3-8b")           # full width and depth
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16,
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] qwen3-8b {cfg.num_layers}L d={cfg.d_model} "
        f"{cfg.param_count() / 1e9:.2f}B params bf16 made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, prefix_sharing=False,
                       prefill_batching=False)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(), serving=sv)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(300, 2001, 6)]
    lengths[0] = max(lengths[0], 1500)           # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]

    checked = {"rows": 0}
    real_sample = paged_engine.sample

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        checked["rows"] += 1
        return real_sample(logits, sp, step)

    # the card's reserved memory after each capture
    reserved = []
    capture = paged_engine.StepClosure.capture

    def noted_capture(self, side, pool):
        out = capture(self, side, pool)
        reserved.append(torch.cuda.memory_reserved() / 2**30)
        return out

    def peaks():
        return (torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.max_memory_reserved() / 2**30)

    paged_engine.sample = finite_sample
    paged_engine.StepClosure.capture = noted_capture
    try:
        torch.cuda.reset_peak_memory_stats()
        eng = PagedEngine(config, params, device="cuda", cuda_graphs=False)
        eager = serve_pass(eng, prompts, "eager", card)
        eager_peak = peaks()
        del eng
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved() / 2**30
        eng = PagedEngine(config, params, device="cuda")
        first = serve_pass(eng, prompts, "graphed, capture pass", card)
        graphs, capture_s = eng.graphs, eng.capture_s
        res = serve_pass(eng, prompts, "graphed, timed pass", card)
        peak = peaks()
        decode_idle_share(eng, prompts, card)
    finally:
        paged_engine.sample = real_sample
        paged_engine.StepClosure.capture = capture
    closures = (len(eng._prefill_fns) + len(eng._decode_fns)
                + len(eng._decode_fallback_fns))
    bound = eng.max_prefill_compiles() + len(eng._decode_fns) \
        + len(eng._decode_fallback_fns)
    log(f"[serve] {graphs} CUDA graphs captured in {capture_s:.2f}s (prefill "
        f"keys {sorted(eng._prefill_fns)}, decode keys "
        f"{sorted(eng._decode_fns)}; bound {bound}); the timed pass captured "
        f"{eng.graphs - graphs}; reserved memory {before:.3f} GiB before the "
        f"engine, after each capture {[round(r, 3) for r in reserved]} GiB "
        f"[{card}]")
    if graphs != closures or graphs > bound or eng.graphs != graphs:
        raise AssertionError(f"{graphs} graphs for {closures} closures "
                             f"(bound {bound}), {eng.graphs - graphs} more "
                             f"in the timed pass")
    for label, r in (("capture pass", first), ("timed pass", res)):
        if r["tokens"] != eager["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                                     eager["tokens"]))
                    if a != b]
            raise AssertionError(f"graphed {label} tokens differ from the "
                                 f"eager tokens in requests {diff}")
    launches, m, splits = res["launches"], res["m"], res["splits"]
    folds = res["variants"]["paged_decode/fold"]
    # B2 runs inside the decode launch: one fused launch per layer of every
    # decode step at S > 1 (counted through the replays), and no reduce
    # launch of its own
    split_steps = sum(n for S, n in splits.items() if S > 1)
    if split_steps <= 0 or launches["decode_reduce"] != 0 or \
            folds != cfg.num_layers * split_steps or \
            sum(splits.values()) != m["decode_calls"]:
        raise AssertionError(
            f"decode steps at S > 1: {split_steps} of {m['decode_calls']} "
            f"({splits}); "
            f"paged_decode/fold launched {folds} times, want "
            f"{cfg.num_layers} a step; decode_reduce {launches['decode_reduce']}"
            f" times, want 0")
    variants = {k: v for k, v in res["variants"].items()
                if k.startswith("paged_prefill/")}
    if variants["paged_prefill/tc"] != launches["paged_prefill"]:
        raise AssertionError(f"bf16 serving launched paged_prefill "
                             f"{launches['paged_prefill']} times, "
                             f"{variants} by instantiation: not all on the "
                             f"tensor-core one")
    arrivals = fd._ARRIVALS[torch.device("cuda", 0)]
    if int(arrivals.abs().sum()) != 0:
        raise AssertionError("fold arrival counters not 0 after the replays")
    shares = {k: r["m"]["decode_dispatch_s"] / r["m"]["decode_s"]
              for k, r in (("eager", eager), ("graphed", res))}
    if not shares["graphed"] < shares["eager"]:
        raise AssertionError(f"decode dispatch share {shares}: graphed not "
                             f"below eager")
    log(f"[serve] {len(prompts)} requests, prompts {lengths}, 32 new tokens "
        f"each, {checked['rows']} logits rows finite; graphed tokens == "
        f"eager tokens (both passes); timed pass launches {launches} (through "
        f"replays); paged_prefill by instantiation {variants}; {split_steps} "
        f"of {m['decode_calls']} decode steps at S > 1 (steps by S "
        f"{splits}), "
        f"paged_decode/fold {folds} = {cfg.num_layers} a step, decode_reduce "
        f"0; fold arrival counters 0")
    for label, r, pk in (("eager", eager, eager_peak),
                         ("graphed", res, peak)):
        rm = r["m"]
        tok_s = rm["prefill_tokens"] / rm["prefill_s"]
        ms_step = 1e3 * rm["decode_s"] / rm["decode_calls"]
        log(f"[serve] {label}: prefill {tok_s:.0f} tok/s, decode "
            f"{ms_step:.3f} ms/step, dispatch share prefill "
            f"{rm['prefill_dispatch_s'] / rm['prefill_s']:.3f} decode "
            f"{rm['decode_dispatch_s'] / rm['decode_s']:.3f}, peak memory "
            f"allocated {pk[0]:.3f} GiB, reserved {pk[1]:.3f} GiB [{card}]")
    report["launches"].update(launches)
    # B2's kernel-line count: the launches in which its fold ran
    report["launches"]["decode_reduce"] = folds
    report["serve"] = dict(prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
                           decode_ms_step=1e3 * m["decode_s"]
                           / m["decode_calls"], peak_gib=peak[0])
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path
# ---------------------------------------------------------------------------

def parity_tiny():
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ModelConfig, \
        ParallelConfig, ServingConfig
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine, Request
    from repro_torch.serving.requests import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, qk_norm=True)
    iso = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                    chunk_align=8)
    cpu_params = api.init_params(0, cfg, dtype=torch.float32, device="cpu")

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(to_cuda(v) for v in tree)
        return tree.cuda()

    cuda_params = to_cuda(cpu_params)
    cases = [("mixed", (70, 12, 33, 7), 3, 5,
              dict(prefill_token_budget=16, max_len=160)),
             ("splits4", (70, 12, 33, 7), 3, 5,
              dict(prefill_token_budget=16, max_len=160, decode_kv_splits=4)),
             ("preempt", (40, 40), 6, 8,
              dict(prefill_token_budget=64, max_len=64, num_pages=8))]
    for name, lens, seed, new, kw in cases:
        outs = {}
        for dev, params in (("cuda", cuda_params), ("cpu", cpu_params)):
            sv = ServingConfig(page_size=8, max_batch=2, prefix_sharing=False,
                               prefill_batching=False, **kw)
            eng = PagedEngine(Config(model=cfg,
                                     parallel=ParallelConfig(data=1, model=1),
                                     iso=iso, serving=sv), params, device=dev)
            rng = np.random.default_rng(seed)
            rids = [eng.add_request(Request(
                prompt=rng.integers(2, 64, n).astype(np.int32),
                sampling=SamplingParams(max_new_tokens=new, eos_id=-1)))
                for n in lens]
            res = eng.run_until_complete()
            outs[dev] = ([res[r] for r in rids], eng.metrics["preemptions"])
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"{name}: cuda {outs['cuda']} != cpu "
                                 f"{outs['cpu']}")
        if name == "preempt" and outs["cuda"][1] <= 0:
            raise AssertionError("preemption case did not preempt")
        log(f"[parity] {name}: cuda == cpu greedy tokens "
            f"(preemptions {outs['cuda'][1]})")


# ---------------------------------------------------------------------------
# phase 5: tensor parallelism at tp=2, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP_NEW_TOKENS = 16
PROFILE_NEW = 4          # new tokens of the profiled quantized run
# (reduce, decode schedule) of each full-width run; "auto" is batch_split
TP_BIG_VARIANTS = (("default", "auto"), ("default", "sequential"),
                   ("quantized_comm", "auto"),
                   ("quantized_comm", "sequential"))
TP_LABEL = "gloo, one card: no overlap measured"


COLLECTIVE_PATTERNS = ("sync", "pipelined", "sync+ops", "pipelined+ops")
STAGE_OPS = 40           # small launches between two reduces of a decode step


def collective_ms(group, shape, quantized: bool, pattern: str,
                  n: int = 20) -> float:
    """Host ms per bf16 all-reduce (int8 ``quantized_psum`` when
    ``quantized``) of ``shape`` over the group, after a warm-up.  Patterns:
    ``sync`` reduces one after another with ``psum_now``; ``pipelined``
    issues them in the batch-split decode order, each started with
    ``psum_start`` before the previous one is completed with ``psum_wait``,
    so one is in flight while the other finishes; ``+ops`` enqueues
    ``STAGE_OPS`` small elementwise launches after each issue, standing for
    the dispatch of one half's stage between two reduces."""
    import torch
    from repro_torch.core.overlap import psum_now, psum_start, psum_wait
    ctx = group.axis_ctx(quantized)
    x = torch.ones(shape, dtype=torch.bfloat16, device=group.device)
    y = torch.ones(shape, dtype=torch.bfloat16, device=group.device)

    def ops():
        if pattern.endswith("+ops"):
            z = y
            for _ in range(STAGE_OPS):
                z = z * 0.5 + y

    def run(k):
        if pattern.startswith("sync"):
            for _ in range(k):
                psum_now(x.clone(), ctx)
                ops()
            return
        pend = psum_start(x.clone(), ctx)
        ops()
        for _ in range(k - 1):
            nxt = psum_start(x.clone(), ctx)
            ops()
            psum_wait(pend)
            pend = nxt
        psum_wait(pend)

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


class PsumTimers:
    """Host seconds spent inside ``psum_start`` and ``psum_wait`` (and so
    ``psum_now``) while serving, split by phase: a partial whose sequence
    dim is 1 is a decode reduce, any other a prefill one.  Wraps the names
    that ``core/iso.py`` and ``core/overlap.py`` call; ``restore`` puts the
    originals back."""

    def __init__(self):
        from repro_torch.core import iso, overlap
        self.mods = (iso, overlap)
        self.orig = {n: getattr(overlap, n) for n in ("psum_start",
                                                      "psum_wait")}
        self.acc = {}
        for mod in self.mods:
            for name, fn in self.orig.items():
                setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            part = args[0].partial if name == "psum_wait" else args[0]
            phase = "decode" if part.shape[-2] == 1 else "prefill"
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            key = f"{phase} {name}"
            s, n = self.acc.get(key, (0.0, 0))
            self.acc[key] = (s + time.perf_counter() - t0, n + 1)
            return out
        return timed

    def restore(self):
        for mod in self.mods:
            for name, fn in self.orig.items():
                setattr(mod, name, fn)


def tp_rank(group, big, tiny):
    """Body of each rank (module level: the spawned ranks import it):
    time one reduce at the decode and prefill shapes in each pattern, serve
    the full-width variants one at a time with the host time inside the
    reduces recorded, freeing the weights after each, a short quantized
    batch-split run under the host profiler, then the tiny ones.
    ``big``/``tiny`` are ``serve_rank`` arguments after the group."""
    import torch
    from repro_torch.launch.serve import serve_rank
    d = big[0].model.d_model
    shapes = {"decode half (2, 1, d)": (2, 1, d),
              "prefill chunk (1, 256, d)": (1, 256, d)}
    out = {"collective_ms": {
        f"{name} {'int8' if q else 'bf16'} {pattern}":
            collective_ms(group, shape, q, pattern)
        for name, shape in shapes.items() for q in (False, True)
        for pattern in COLLECTIVE_PATTERNS}}
    config, variants, npz, seed, dtype = big
    out["big"] = []
    timers = PsumTimers()
    try:
        for v in variants:
            timers.acc = {}
            res = serve_rank(group, config, [v], npz, seed, dtype)[0]
            res["psum_host_s"] = timers.acc
            out["big"].append(res)
            torch.cuda.empty_cache()
    finally:
        timers.restore()
    # the quantized batch-split run again, short, under the host profiler:
    # which calls the host waits in
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_rank(group, config, [dict(variants[2], max_new=PROFILE_NEW)],
                   npz, seed, dtype)
    out["profile"] = prof.key_averages().table(
        sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=48)
    torch.cuda.empty_cache()
    out["tiny"] = serve_rank(group, *tiny)
    return out


def tiny_config(tp: int):
    from repro_torch.config import Config, ISOConfig, ModelConfig, \
        ParallelConfig, ServingConfig
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, qk_norm=True)
    return Config(model=cfg, parallel=ParallelConfig(data=1, model=tp),
                  iso=ISOConfig(enabled=True, num_chunks=2,
                                min_chunk_tokens=8, chunk_align=8),
                  serving=ServingConfig(page_size=8, max_batch=2,
                                        max_len=160, prefix_sharing=False,
                                        prefill_batching=False))


def serve_tp(report, card: str):
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import serve_rank

    cfg = get_model_config("qwen3-8b")           # full width and depth
    rng = np.random.default_rng(1)
    lengths = [int(n) for n in rng.integers(300, 1201, 3)]
    lengths[0] = max(lengths[0], 900)            # at least one resumed grant
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    sv = ServingConfig(page_size=16, max_batch=4, max_len=2048,
                       prefill_token_budget=512, prefix_sharing=False,
                       prefill_batching=False)
    big_cfg = Config(model=cfg, parallel=ParallelConfig(data=1, model=2),
                     iso=ISOConfig(), serving=sv)
    big = (big_cfg, [dict(prompts=prompts, max_new=TP_NEW_TOKENS,
                          serving=dict(decode_schedule=sched),
                          iso=dict(quantized_comm=label == "quantized_comm"))
                     for label, sched in TP_BIG_VARIANTS],
           None, 0, "bfloat16")
    rng = np.random.default_rng(3)
    tiny_prompts = [rng.integers(2, 64, n).astype(np.int32)
                    for n in (70, 12, 33, 7)]
    tiny_cases = {"mixed": dict(prefill_token_budget=16),
                  "splits4": dict(prefill_token_budget=64,
                                  decode_kv_splits=4)}
    tiny_keys = [(c, sched) for c in tiny_cases
                 for sched in ("sequential", "batch_split", "cross_block")]
    tiny = (tiny_config(2),
            [dict(prompts=tiny_prompts, max_new=5,
                  serving=dict(tiny_cases[c], decode_schedule=sched))
             for c, sched in tiny_keys], None, 0, "float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    want = {c: serve_rank(None, tiny_config(1),
                          [dict(prompts=tiny_prompts, max_new=5,
                                serving=tiny_cases[c])], None, 0, "float32",
                          device="cuda")[0]["tokens"] for c in tiny_cases}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(tp_rank, 2, args=(big, tiny), device="cuda:0",
                  backend="gloo", timeout_s=900)
    log(f"[tp] 2 ranks on cuda:0 over gloo, {time.perf_counter() - t0:.1f}s "
        f"with start-up and weights")
    coll = ranks[0]["collective_ms"]
    log(f"[tp] one reduce, host ms per reduce ({TP_LABEL}; patterns: sync = "
        f"one after another, pipelined = batch-split order with one in "
        f"flight, +ops = {STAGE_OPS} small launches between reduces):")
    for k, v in coll.items():
        log(f"[tp]   {k}: {v:.3f}")
    log(f"[tp]   [{card}]")

    for i, (label, sched) in enumerate(TP_BIG_VARIANTS):
        runs = [r["big"][i] for r in ranks]
        run = runs[0]
        m, launches = run["metrics"], run["launches"]
        name = f"{label}/{run['decode_schedule']}"
        if any(r["tokens"] != run["tokens"] for r in runs):
            raise AssertionError(f"[tp] {name}: ranks emitted different "
                                 f"tokens")
        if len(run["tokens"]) != len(prompts) or \
                any(len(t) != TP_NEW_TOKENS for t in run["tokens"]):
            raise AssertionError(f"[tp] {name}: not every request "
                                 f"completed: {m}")
        want_sched = "batch_split" if sched == "auto" else sched
        if run["decode_schedule"] != want_sched or \
                run["schedule_steps"].get(want_sched, 0) <= 0:
            raise AssertionError(f"[tp] {name}: {want_sched} decode did not "
                                 f"run: {run['schedule_steps']}")
        if m["resumed_grants"] <= 0:
            raise AssertionError(f"[tp] {name}: no resumed grant ran")
        for kname in ATTENTION_KERNELS:
            if launches[kname] <= 0:
                raise AssertionError(f"[tp] {name}: {kname} never launched: "
                                     f"{launches}")
        steps = m["decode_calls"]
        step_ms = 1e3 * m["decode_s"] / steps
        ph = run["psum_host_s"]
        # every int8 reduce is three kernel launches, one of each, and no
        # standalone B7; a bf16 run launches none of them
        n_reduces = sum(n for k, (_, n) in ph.items()
                        if k.endswith("psum_start"))
        int8 = {k: launches[k] for k in INT8_REDUCE_KERNELS}
        want_int8 = n_reduces if label == "quantized_comm" else 0
        if n_reduces <= 0 or launches["quantize_int8"] != 0 or \
                any(n != want_int8 for n in int8.values()):
            raise AssertionError(f"[tp] {name}: {n_reduces} reduces, int8 "
                                 f"launches {int8}, quantize_int8 "
                                 f"{launches['quantize_int8']}: want "
                                 f"{want_int8} of each and 0")
        inside = {k: (1e3 * t / steps if k.startswith("decode")
                      else 1e3 * t, n)
                  for k, (t, n) in sorted(ph.items())}
        log(f"[tp] qwen3-8b {cfg.num_layers}L tp=2 bf16 {name}: "
            f"{len(prompts)} requests, prompts {lengths}, "
            f"{TP_NEW_TOKENS} new tokens each, ranks agree, "
            f"{run['rows_checked']} logits rows finite, schedule steps "
            f"{run['schedule_steps']}, launches per rank {launches}")
        log(f"[tp] {name} ({TP_LABEL}): prefill {m['prefill_tokens']} tok "
            f"in {m['prefill_s']:.3f}s = "
            f"{m['prefill_tokens'] / m['prefill_s']:.0f} tok/s "
            f"({m['prefill_calls']} calls, {m['resumed_grants']} resumed); "
            f"decode {step_ms:.2f} ms/step over {steps} steps; host "
            f"dispatch share prefill "
            f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
            f"{m['decode_dispatch_s'] / m['decode_s']:.3f} [{card}]")
        log(f"[tp] {name} rank 0 host time inside the reduces (decode: ms "
            f"per step; prefill: ms in all; calls in all): "
            + ", ".join(f"{k} {v:.2f} ({n})" for k, (v, n) in inside.items()))
        log(f"[tp] {name}: {n_reduces} reduces, int8 kernel launches {int8}"
            f" ({sum(int8.values()) / n_reduces:.0f} a reduce)")
        report.setdefault("tp", {})[name] = dict(
            prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
            decode_ms_step=step_ms, launches=launches,
            schedule_steps=run["schedule_steps"], psum_host=inside)
    log(f"[tp] rank 0 host profile of a quantized_comm/batch_split run "
        f"({PROFILE_NEW} new tokens, {TP_LABEL}), by self CPU time:")
    for line in ranks[0]["profile"].splitlines():
        log("[tp]   " + line)
    # the kernel line's counts: the default quantized run (batch-split)
    for k in INT8_REDUCE_KERNELS:
        report["launches"][k] = ranks[0]["big"][2]["launches"][k]

    for i, (case, sched) in enumerate(tiny_keys):
        for r, rank in enumerate(ranks):
            got = rank["tiny"][i]["tokens"]
            if got != want[case]:
                raise AssertionError(f"[tp] tiny {case}/{sched} rank {r}: "
                                     f"tp=2 {got} != tp=1 {want[case]}")
    log(f"[tp] tiny fp32 model: tp=2 on cuda:0 == tp=1 on the card, greedy "
        f"tokens on every rank, cases {tiny_keys}")


# ---------------------------------------------------------------------------
# phase 7: the kernel entry point at full width
# ---------------------------------------------------------------------------

def serve_ops(report, card: str):
    """Drive ``repro_torch.kernels.ops`` at qwen3-8b's widths in bf16 (tp=1's
    heads and d_ff, then one tp=2 rank's), read the launch counts, then hold
    the ISO composition and every call against the plain versions."""
    import torch
    from repro_torch.kernels import native, ops
    from repro_torch.kernels.flash_prefill import flash_attention_plain
    from repro_torch.kernels.int8_quant import quantize_int8_plain
    from repro_torch.kernels.rmsnorm import rms_norm_plain
    from repro_torch.kernels.swiglu import swiglu_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    dt, S, c, hd, d_model = torch.bfloat16, 2048, 1024, 128, 4096

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # (label, Hq, Hkv, d_ff): qwen3-8b at tp=1, and one rank's share at tp=2
    widths = (("tp=1", 32, 8, 12288), ("tp=2 rank", 16, 4, 6144))
    inputs = [(randn(1, hq, S, hd), randn(1, hkv, S, hd), randn(1, hkv, S, hd),
               randn(S, d_model), randn(d_model, dtype=torch.float32),
               randn(S, d_ff), randn(S, d_ff))
              for _, hq, hkv, d_ff in widths]
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for q, k, v, x, gamma, gate, up in inputs:
        full = ops.flash_attention(q, k, v)
        c0 = ops.flash_attention(q[:, :, :c], k[:, :, :c], v[:, :, :c])
        c1 = ops.flash_attention(q[:, :, c:], k, v, q_start=c)
        outs.append((full, c0, c1, ops.rms_norm(x, gamma),
                     ops.swiglu(gate, up), ops.quantize_int8(x)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: native.LAUNCHES[k]
                for k in OPS_KERNELS + ("quantize_int8",)}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the ops "
                                 f"path: {launches}")
    tol = TOL["bfloat16"]
    for (label, hq, hkv, d_ff), inp, out in zip(widths, inputs, outs):
        q, k, v, x, gamma, gate, up = inp
        full, c0, c1, y, a, xq = out
        for g, w in zip(xq, quantize_int8_plain(x)):
            if not torch.equal(g, w):
                raise AssertionError(f"[ops] {label}: quantize_int8 differs "
                                     f"from its plain version")
        composed = torch.cat([c0, c1], dim=2)
        comp_err = max_err([composed.float()], [full.float()], tol)
        errs = [
            max_err([full.float()],
                    [flash_attention_plain(q, k, v).float()], tol),
            max_err([c0.float()], [flash_attention_plain(
                q[:, :, :c], k[:, :, :c], v[:, :, :c]).float()], tol),
            max_err([c1.float()], [flash_attention_plain(
                q[:, :, c:], k, v, q_start=c).float()], tol),
            max_err([y.float()], [rms_norm_plain(x, gamma).float()], tol),
            max_err([a.float()], [swiglu_plain(gate, up).float()], tol)]
        if full.shape != q.shape or y.shape != x.shape or \
                a.shape != gate.shape:
            raise AssertionError(f"[ops] {label}: output shapes")
        log(f"[ops] qwen3-8b {label} widths (Hq {hq}, Hkv {hkv}, hd {hd}, "
            f"d_model {d_model}, d_ff {d_ff}) bf16: flash({c}) ++ flash({c} "
            f"| prefix {c}) == flash({S}) within {tol}, max abs err "
            f"{comp_err}; each call vs its plain version, max abs err "
            f"(full, chunk 0, chunk 1, rms_norm, swiglu) {errs}; "
            f"quantize_int8 ({S}, {d_model}) equal")
    log(f"[ops] {wall:.3f}s for the calls, launches {launches} [{card}]")
    report["launches"].update(launches)


def tc_report(logs: str) -> list:
    """ptxas's register and spill lines of the tensor-core instantiations
    (``*_tc_kernel<KD>``), one line each."""
    import re
    out, cur = [], ""
    for line in logs.splitlines():
        if "Compiling entry function" in line:
            hit = re.search(r"([a-z_]+_tc_kernel)ILi(\d+)E", line)
            cur = f"{hit.group(1)}<{hit.group(2)}>" if hit else ""
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    native.build_all()
    native.library()
    card = nvidia_smi()
    log(f"[build] {time.perf_counter() - t0:.1f}s  nvcc report:")
    for line in "".join(native.BUILD_LOGS.values()).splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())
    log("[build] tensor-core instantiations (flash_tc.cuh), registers and "
        "spills:")
    for line in tc_report("".join(native.BUILD_LOGS.values())):
        log("  " + line)
    log(f"[build] card: {card}")

    report = {"launches": {}}
    check_kernels(report)
    serve_full(report, card)
    parity_tiny()
    serve_tp(report, card)
    time_kernels(report)
    serve_ops(report, card)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = report["timing"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": report["launches"][name],
                        "max_abs_err": report["errs"][name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
        assert all(math.isfinite(x) for x in (t["ms"], t["plain_ms"],
                                              t["bound_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
