#!/usr/bin/env python3
"""Serve qwen3-8b on one card from two checkouts of the repo in turns, to
compare two commits on the same machine.

    python3 serve_ab.py OTHER

OTHER is another checkout of the repo (a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, say).  Each run
is one process that builds its checkout's kernels and runs that checkout's
``chip_smoke.serve_full`` (phase 3: qwen3-8b at full width and depth, bf16,
six greedy requests).  The runs go OTHER, this, this, OTHER, and again, until
each side has ``RUNS`` runs, so neither side gains from its place in the
order.  Each run also times the host work (until the calls return, before
waiting for the card) of the paged-decode (B1) wrapper over its calls in the
serving run (``decode_folded``, which folds the split-KV spans in the same
launch, or ``decode_partials`` in a checkout without it), of the split-KV
reduce (B2) wrapper ``decode_reduce`` (no call where the fold runs in the
decode launch), and of the paged-prefill (B3) wrapper
``flash_prefill_paged`` over its calls in the serving run and over 200 calls
in a row at the serving path's shape (a 256-query ISO chunk over a
1024-token prefix, Hq/Hkv 32/8, hd 128, bf16).  On a checkout whose engine
replays CUDA graphs the wrappers run only in its eager pass and while
capturing, so beside them each run reports the engine's own host time per
decode step (``decode_dispatch_s / decode_calls``, until the step's call
returns) of the last serving run of ``serve_full``: the timed graphed pass
on such a checkout, the one eager run on an older one.  Where ``serve_full``
also serves the reference's defaults (its ``serve_defaults`` pass, run
first), the wrappers' calls include that pass's; the engine's host time
and ``report["serve"]`` stay the baseline pass's.  Prints every run,
then each side's median, minimum and maximum, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUNS = 10                # of each side
LOOP_CALLS = 200
KEYS = ("prefill_tok_s", "decode_ms_step", "decode_host_us", "b3_host_us",
        "b3_loop_us", "b1_host_us", "b2_host_us", "b2_calls")


def b3_loop_us(smoke, fp) -> float:
    """Host microseconds per B3 wrapper call, ``LOOP_CALLS`` calls in a row
    at the serving path's ISO-chunk shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    k, v, bt, lens = smoke.make_pool(gen, [1024], 16, 8, 128, torch.bfloat16,
                                     mb=128)
    q = torch.randn((1, 32, 256, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qs = lens + 256
    for _ in range(10):
        fp.flash_prefill_paged(q, k, v, bt, lens, qs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_CALLS):
        fp.flash_prefill_paged(q, k, v, bt, lens, qs)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / LOOP_CALLS


def child() -> None:
    """One run, from the checkout in the working directory."""
    sys.path[0] = os.getcwd()        # that checkout's chip_smoke and src
    import chip_smoke as smoke
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill_paged as fp
    from repro_torch.kernels import native
    from repro_torch.serving.paged_engine import PagedEngine
    native.build_all()
    # the metrics of the last serving run
    runs = []
    run_until_complete = PagedEngine.run_until_complete

    def recorded(self, *args, **kwargs):
        out = run_until_complete(self, *args, **kwargs)
        runs.append(dict(self.metrics))
        return out
    # the B3, B1 and B2 wrappers, timed in place: layers/attention.py looks
    # up flash_prefill_paged per call, flash_decode the B1 and B2 wrappers
    host = {"b3": [], "b1": [], "b2": []}
    b1 = "decode_folded" if hasattr(fd, "decode_folded") else \
        "decode_partials"
    wrappers = {"b3": (fp, "flash_prefill_paged"), "b1": (fd, b1),
                "b2": (fd, "decode_reduce")}

    def timed(key, wrapper):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = wrapper(*args, **kwargs)
            host[key].append(time.perf_counter() - t0)
            return out
        return call

    orig = {key: getattr(mod, name) for key, (mod, name) in wrappers.items()}
    for key, (mod, name) in wrappers.items():
        setattr(mod, name, timed(key, orig[key]))
    PagedEngine.run_until_complete = recorded
    report = {"launches": {}}
    try:
        smoke.serve_full(report, smoke.nvidia_smi())
    finally:
        for key, (mod, name) in wrappers.items():
            setattr(mod, name, orig[key])
        PagedEngine.run_until_complete = run_until_complete
    m = runs[-1]
    print("SERVE_AB " + json.dumps(dict(
        report["serve"],
        decode_host_us=1e6 * m["decode_dispatch_s"] / m["decode_calls"],
        b3_calls=len(host["b3"]),
        b3_host_us=1e6 * statistics.mean(host["b3"]),
        b1_calls=len(host["b1"]),
        b1_host_us=1e6 * statistics.mean(host["b1"]),
        b2_calls=len(host["b2"]),
        b2_host_us=1e6 * statistics.mean(host["b2"]) if host["b2"] else 0.0,
        b3_loop_us=b3_loop_us(smoke, fp))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child()
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi
    card = nvidia_smi()
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for label in ["other", "this", "this", "other"] * (RUNS // 2):
        res = subprocess.run(
            [sys.executable, str(ROOT / "serve_ab.py"), str(trees[label]),
             "--child"], cwd=trees[label], capture_output=True, text=True,
            timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"the run in {trees[label]} failed:\n"
                               f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
        r = json.loads([ln for ln in res.stdout.splitlines()
                        if ln.startswith("SERVE_AB ")][-1][len("SERVE_AB "):])
        runs[label].append(r)
        print(f"[ab] {label} ({trees[label]}): prefill {r['prefill_tok_s']} "
              f"tok/s, decode {r['decode_ms_step']} ms/step, host "
              f"{r['decode_host_us']} us a decode step; B3 wrapper host "
              f"{r['b3_host_us']} us a call over {r['b3_calls']} serving "
              f"calls, {r['b3_loop_us']} us in a loop; B1 wrapper host "
              f"{r['b1_host_us']} us a call over {r['b1_calls']} serving "
              f"calls; B2 wrapper host {r['b2_host_us']} us a call over "
              f"{r['b2_calls']} serving calls", flush=True)
    for label, rs in runs.items():
        for key in KEYS:
            xs = [r[key] for r in rs]
            print(f"[ab] {label} {key} over {len(xs)} runs: median "
                  f"{statistics.median(xs)}, min {min(xs)}, max {max(xs)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
