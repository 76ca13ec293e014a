#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Phases, each fatal on failure:

  1. build     compile the port's CUDA kernels from ``src/repro_torch/kernels/
               csrc`` with nvcc; print the build time, the compiler's
               register/shared-memory report and the card's name and power
               limit.
  2. kernels   hold each kernel against its plain PyTorch version on the
               card, at the serving path's shapes (Hq 32, Hkv 8, hd 128,
               ps 16, lengths 1..2048 across page boundaries, S in {1, 4},
               window 0 and > 0, fresh rows beside resumed rows) and at the
               CPU tests' shapes (hd 16, ps 8), fp32 and bf16 pools; check
               the dead-page skip is bit-identical; time each kernel.
  3. serve     the main path: ``PagedEngine`` serving qwen3-8b at full width
               and depth in bf16 (random weights from a seed) on 6 greedy
               requests of 300-2000 prompt tokens; the launch counters of
               all three kernels must be > 0, logits finite, every request
               complete and every page free at the end.
  4. parity    a tiny fp32 model served on ``cuda`` and on ``cpu`` from the
               same weights must give equal greedy tokens (mixed traffic,
               forced 4-way split-KV decode, forced preemption).

It imports nothing of JAX or of the JAX package.  The last line is
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
}


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


def check_kernels(report):
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"paged_decode": 0.0, "decode_reduce": 0.0, "paged_prefill": 0.0}

    def decode_case(lengths, ps, hq, hkv, hd, K, S, window, dtype_name):
        dtype = getattr(torch, dtype_name)
        k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dtype)
        q = torch.randn((len(lengths), K, hq, hd), generator=gen,
                        device="cuda").to(dtype)
        group = hq // hkv
        qg = q.reshape(len(lengths), K, hkv, group, hd).permute(
            0, 2, 3, 1, 4).reshape(len(lengths), hkv, group * K, hd)
        S = max(1, min(S, bt.shape[1]))
        got = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K,
                                 window=window, kv_splits=S)
        want = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                        window=window, kv_splits=S)
        tol = TOL[dtype_name]
        errs["paged_decode"] = max(errs["paged_decode"],
                                   max_err(got, want, tol))
        walked = fd.decode_partials(qg, k, v, bt, lens, k_tokens=K,
                                    window=window, kv_splits=S,
                                    guard_dead_pages=False)
        for a, b in zip(got, walked):
            if not torch.equal(a, b):
                raise AssertionError("dead-page skip is not bit-identical")
        if S > 1:
            red = fd.decode_reduce(*got)
            red_plain = fd.decode_reduce_plain(*got)
            errs["decode_reduce"] = max(errs["decode_reduce"],
                                        max_err(red, red_plain, TOL["float32"]))
        # the whole wrapper (reduce included) against the plain pipeline
        o = fd.flash_decode(q, k, v, bt, lens, window=window, kv_splits=S)
        po, pm, pl = fd.decode_partials_plain(qg, k, v, bt, lens, k_tokens=K,
                                              window=window, kv_splits=S)
        if S > 1:
            po, pm, pl = fd.decode_reduce_plain(po, pm, pl)
        else:
            po, pm, pl = po[:, :, 0], pm[:, :, 0], pl[:, :, 0]
        B = len(lengths)
        unrow = lambda t, last: t.reshape(B, hkv, group, K, last).permute(
            0, 3, 1, 2, 4).reshape(B, K, hq, last)
        max_err(o, (unrow(po, hd), unrow(pm, 1), unrow(pl, 1)), tol)

    def prefill_case(prefix_lens, offsets, Sq, ps, hq, hkv, hd, window,
                     dtype_name):
        dtype = getattr(torch, dtype_name)
        k, v, bt, lens = make_pool(gen, prefix_lens, ps, hkv, hd, dtype)
        q = torch.randn((len(prefix_lens), hq, Sq, hd), generator=gen,
                        device="cuda").to(dtype)
        qs = lens + torch.tensor(offsets, dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_paged(q, k, v, bt, lens, qs, window=window)
        want = fp.prefill_partial_plain(q, k, v, bt, lens, qs, window=window)
        errs["paged_prefill"] = max(errs["paged_prefill"],
                                    max_err(got, want, TOL[dtype_name]))
        if float(got[0][0].abs().max()) != 0.0 or \
                float(got[2][0].max()) != 0.0:
            raise AssertionError("fresh row (prefix 0) is not neutral")

    main_lengths = [1, 15, 16, 17, 255, 256, 257, 1000, 2047, 2048]
    n = 0
    for dtype_name in ("bfloat16", "float32"):
        for S in (1, 4):
            for window in (0, 100):
                decode_case(main_lengths, 16, 32, 8, 128, 1, S, window,
                            dtype_name)
                n += 1
        for K, S, window in ((1, 1, 0), (2, 4, 12), (4, 2, 0)):
            decode_case([1, 7, 8, 9, 22, 37, 0], 8, 4, 2, 16, K, S, window,
                        dtype_name)
            n += 1
        for window in (0, 100):
            prefill_case([0, 700, 2000], [0, 0, 256], 512, 16, 32, 8, 128,
                         window, dtype_name)
            n += 1
        for window in (0, 5):
            prefill_case([0, 11, 24, 15], [0, 3, 0, 5], 10, 8, 4, 2, 16,
                         window, dtype_name)
            n += 1
    torch.cuda.synchronize()
    log(f"[kernels] {n} cases within tolerance {TOL}; dead-page skip "
        f"bit-identical; max abs err {errs}")
    report["errs"] = errs


def time_kernels(report):
    """Time each kernel and its plain version at the serving path's shapes:
    decode B=4 rows of 700/1200/1700/2030 resident tokens (MB=128) with
    S=4 spans, as the engine splits walks past 16 pages; the reduce of those
    spans; a 512-token resumed chunk over a 1024-token prefix."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    ps, hq, hkv, hd, S, K = 16, 32, 8, 128, 4, 1
    group = hq // hkv
    gk = group * K
    lengths = [700, 1200, 1700, 2030]
    B = len(lengths)
    k, v, bt, lens = make_pool(gen, lengths, ps, hkv, hd, dt, mb=128)
    qg = torch.randn((B, hkv, gk, hd), generator=gen, device="cuda").to(dt)
    dec = lambda: fd.decode_partials(qg, k, v, bt, lens, k_tokens=K,
                                     window=0, kv_splits=S)
    dec_plain = lambda: fd.decode_partials_plain(qg, k, v, bt, lens,
                                                 k_tokens=K, window=0,
                                                 kv_splits=S)
    parts = dec()
    red = lambda: fd.decode_reduce(*parts)
    red_plain = lambda: fd.decode_reduce_plain(*parts)
    walked_pages = sum(-(-L // ps) for L in lengths)
    tokens = sum(lengths)
    out_bytes = B * hkv * S * gk * (hd + 2) * 4
    dec_bytes = (qg.numel() * 2 + bt.numel() * 4 + B * 4
                 + 2 * walked_pages * ps * hkv * hd * 2 + out_bytes)
    dec_ops = 4 * tokens * hq * hd
    red_bytes = out_bytes + B * hkv * gk * (hd + 2) * 4
    red_ops = 4 * B * hkv * S * gk * hd

    Sq, prefix = 512, 1024
    pk, pv, pbt, plens = make_pool(gen, [prefix], ps, hkv, hd, dt, mb=128)
    q = torch.randn((1, hq, Sq, hd), generator=gen, device="cuda").to(dt)
    qs = plens + 512
    pre = lambda: fp.flash_prefill_paged(q, pk, pv, pbt, plens, qs)
    pre_plain = lambda: fp.prefill_partial_plain(q, pk, pv, pbt, plens, qs)
    pre_bytes = (q.numel() * 2 + pbt.numel() * 4 + 8
                 + 2 * prefix * hkv * hd * 2 + hq * Sq * (hd + 2) * 4)
    pre_ops = 4 * Sq * prefix * hq * hd

    cases = {
        "paged_decode": (dec, dec_plain, dec_bytes, dec_ops, "bfloat16",
                         f"B={B} L={lengths} Hq={hq} Hkv={hkv} hd={hd} "
                         f"ps={ps} MB=128 S={S} bf16"),
        "decode_reduce": (red, red_plain, red_bytes, red_ops, "float32",
                          f"B={B} Hkv={hkv} S={S} gk={gk} hd={hd} fp32"),
        "paged_prefill": (pre, pre_plain, pre_bytes, pre_ops, "bfloat16",
                          f"B=1 Sq={Sq} prefix={prefix} Hq={hq} Hkv={hkv} "
                          f"hd={hd} ps={ps} MB=128 bf16"),
    }
    timing = {}
    for name, (fn, plain, nbytes, ops, kind, shape) in cases.items():
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=5)
        eager_ms = call_ms(fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[kind] * 1e3
        timing[name] = dict(ms=ms, plain_ms=plain_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations", shape=shape,
                            bytes=nbytes, ops=ops, eager_ms=eager_ms)
        log(f"[time] {name}: {ms:.4f} ms on the device, {eager_ms:.4f} ms "
            f"per eager call with the wrapper's host work (plain "
            f"{plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.5f} ms by {timing[name]['bound_by']}, "
            f"library_ms none: no single PyTorch call computes paged "
            f"attention over block tables) at {shape}")
    report["timing"] = timing


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def serve_full(report, card: str):
    import numpy as np
    import torch
    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        ServingConfig, get_model_config
    from repro_torch.kernels import native
    from repro_torch.models import api
    from repro_torch.serving import PagedEngine, Request, paged_engine
    from repro_torch.serving.requests import SamplingParams

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
    eng = PagedEngine(config, params, device="cuda")

    checked = {"rows": 0}
    real_sample = paged_engine.sample

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        checked["rows"] += 1
        return real_sample(logits, sp, step)

    paged_engine.sample = finite_sample
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(300, 2001, 6)]
    lengths[0] = max(lengths[0], 1500)           # at least one resumed grant
    for n in lengths:
        eng.add_request(Request(
            prompt=rng.integers(2, cfg.vocab_size, n).astype(np.int32),
            sampling=SamplingParams(max_new_tokens=32, eos_id=-1)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    try:
        outs = eng.run_until_complete()
    finally:
        paged_engine.sample = real_sample
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    m = eng.metrics
    if len(outs) != len(lengths) or any(len(t) != 32 for t in outs.values()):
        raise AssertionError(f"not every request completed: {m}")
    if eng.alloc.free_pages != eng.alloc.num_pages:
        raise AssertionError("pages leaked")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path: {launches}")
    if m["resumed_grants"] <= 0:
        raise AssertionError("no resumed grant ran")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {len(outs)} requests, prompts {lengths}, 32 new tokens "
        f"each, {checked['rows']} logits rows finite, wall {wall:.1f}s, "
        f"launches {launches}")
    log(f"[serve] prefill {m['prefill_tokens']} tok in {m['prefill_s']:.3f}s "
        f"= {m['prefill_tokens'] / m['prefill_s']:.0f} tok/s "
        f"({m['prefill_calls']} calls, {m['resumed_grants']} resumed); decode "
        f"{1e3 * m['decode_s'] / m['decode_calls']:.2f} ms/step over "
        f"{m['decode_calls']} steps; peak memory {peak:.2f} GiB; "
        f"preemptions {m['preemptions']} [{card}]")
    # host time until the eager calls return, before waiting for the card:
    # close to the fenced time means the host never got ahead of the card
    log(f"[serve] host dispatch share: prefill "
        f"{m['prefill_dispatch_s'] / m['prefill_s']:.3f}, decode "
        f"{m['decode_dispatch_s'] / m['decode_s']:.3f} of the fenced time")
    report["launches"] = launches
    report["serve"] = dict(prefill_tok_s=m["prefill_tokens"] / m["prefill_s"],
                           decode_ms_step=1e3 * m["decode_s"]
                           / m["decode_calls"], peak_gib=peak)
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
    log(f"[build] card: {card}")

    report = {}
    check_kernels(report)
    serve_full(report, card)
    parity_tiny()
    time_kernels(report)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = report["timing"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": report["launches"][name],
                        "max_abs_err": report["errs"][name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": None})
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
