"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the correctness check and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; the harness
finds its files by name: ``configs/<config>.json`` (the model's sizes),
``traffic/<traffic>.json`` (the mix), ``cells/<cell>.json`` (the engine's
settings and the correctness limits) and ``metrics/<metric>.py`` (one
reader a metric).  Adding a cell or a metric is adding files and entries.

The timed path is the port's ``PagedEngine`` at tp=1 (``add_request``,
``step``), every step a CUDA-graph replay.  Closed-loop clients each keep
one request in the engine: when a request's last token comes back, its
client sends the next one before the next step.  Time stamps are taken on
the host when ``step()`` returns (each of its calls waits for the card).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import counts
import stats
import traffic as traffic_lib

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# the traced slice after the window: at most this long and this many steps
TRACE_SECONDS = 2.0
TRACE_MAX_STEPS = 60


def process_start_time() -> Optional[float]:
    """This process's start on the wall clock (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# the manifest and a cell's files
# --------------------------------------------------------------------------

def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A workload of the manifest with its files."""

    def __init__(self, name: str, manifest: Dict, root: Path = BENCH):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the manifest; have "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.cfg = load_json(root / "configs" / f"{self.entry['config']}.json")
        self.mix = traffic_lib.load(self.entry["traffic"], root / "traffic")
        self.settings = load_json(root / "cells" / f"{name}.json")
        self.chips = int(self.entry.get("chips", 1))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if applies(m, name)]
        self.root = root

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


# --------------------------------------------------------------------------
# the program under test
# --------------------------------------------------------------------------

def module(name: str):
    """A module of ``bench/`` named by a configuration file: its ``port``
    (the port's ``model_config``), ``weights`` (``make``) and ``reference``
    (``Reference``), so a new model family adds its modules and files and
    edits none."""
    if not name.isidentifier():
        raise ValueError(f"{name!r} is not a module name of bench/")
    return importlib.import_module(name)


def model_config(cfg: Dict):
    """The port's ModelConfig of a configuration file."""
    return module(cfg["port"]).model_config(cfg)


def build_engine(cell: Cell, params, device):
    from repro_torch.config import Config, ServingConfig
    from repro_torch.serving import PagedEngine
    eng = cell.settings["engine"]
    sv = ServingConfig(max_batch=int(eng["max_batch"]),
                       max_len=int(eng["max_len"]),
                       prefill_token_budget=int(eng["prefill_token_budget"]))
    return PagedEngine(Config(model=model_config(cell.cfg), serving=sv),
                       params, device=device)


# --------------------------------------------------------------------------
# clients and the loop
# --------------------------------------------------------------------------

class Req:
    __slots__ = ("rid", "prompt", "max_new", "sent", "stamps", "tokens",
                 "done", "stream")

    def __init__(self, rid, prompt, max_new, sent, stream):
        self.rid, self.prompt, self.max_new = rid, prompt, max_new
        self.sent, self.stream = sent, stream
        self.stamps: List[float] = []
        self.tokens: List[int] = []
        self.done: Optional[float] = None

    @property
    def first(self) -> Optional[float]:
        return self.stamps[0] if self.stamps else None


class Clients:
    """``n`` closed-loop clients over one engine."""

    def __init__(self, engine, mix: Dict, vocab: int, seed: int):
        from repro_torch.serving.requests import Request, SamplingParams
        self._Request, self._Sampling = Request, SamplingParams
        self.engine = engine
        self.n = int(mix["clients"])
        self.eos = int(mix.get("eos_id", -1))
        if not mix.get("greedy", True):
            raise ValueError("the correctness check reads greedy tokens only")
        self.streams = {s: traffic_lib.requests(mix, vocab, seed, s)
                        for s in (traffic_lib.WARMUP_STREAM,
                                  traffic_lib.WINDOW_STREAM)}
        self.stream = traffic_lib.WARMUP_STREAM
        self.idle = self.n
        self.reqs: Dict[int, Req] = {}
        self.order: List[Req] = []
        self._rid = 0
        # the clients' first requests start part-way through their lives
        self._cohort = list(traffic_lib.cohort_fractions(self.n, seed))

    def send_one(self, prompt, max_new: int, now: float,
                 stream: int) -> Req:
        r = Req(self._rid, prompt, max_new, now, stream)
        self._rid += 1
        self.engine.add_request(self._Request(
            prompt=prompt, rid=r.rid, sampling=self._Sampling(
                temperature=0.0, max_new_tokens=max_new, eos_id=self.eos)))
        self.reqs[r.rid] = r
        self.order.append(r)
        return r

    def send(self, now: float) -> None:
        while self.idle:
            prompt, max_new = next(self.streams[self.stream])
            if self._cohort:
                max_new = max(1, int(round(max_new * self._cohort.pop())))
            self.send_one(prompt, max_new, now, self.stream)
            self.idle -= 1

    def receive(self, events, now: float) -> List[tuple]:
        """Stamp a step's tokens; returns (request, token index) of each."""
        out = []
        for rid, tok in events:
            r = self.reqs[rid]
            r.stamps.append(now)
            r.tokens.append(int(tok))
            out.append((r, len(r.tokens) - 1))
            if len(r.tokens) >= r.max_new:
                r.done = now
                if r.stream != traffic_lib.SWEEP_STREAM:
                    self.idle += 1
        return out


def drive(engine, clients: Clients, stop, ranges: bool = False,
          on_step=None, fill: bool = True) -> float:
    """Step until ``stop(now, steps)``; returns the last step's stamp.
    ``fill``: idle clients send before each step."""
    import torch
    rf = torch.profiler.record_function if ranges else \
        (lambda _name: contextlib.nullcontext())
    steps = 0
    while True:
        with rf("bench/client"):
            if fill:
                clients.send(time.perf_counter())
        with rf("bench/step"):
            events = engine.step()
        now = time.perf_counter()
        with rf("bench/client"):
            got = clients.receive(events, now)
        steps += 1
        if on_step is not None:
            on_step(got)
        if stop(now, steps):
            return now


# --------------------------------------------------------------------------
# the run record the metric readers read
# --------------------------------------------------------------------------

COUNTERS = ("prefill_s", "decode_s", "prefill_tokens", "prefill_pad_tokens",
            "decode_calls", "steps")


class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.sizes = counts.Sizes(cell.cfg)
        self.setup_s = 0.0
        self.t0 = self.t1 = 0.0
        self.c0: Dict[str, float] = {}
        self.c1: Dict[str, float] = {}
        self.requests: List[Req] = []
        self.slice = None               # devtrace.Slice of the traced run
        self.slice_rows: List[List[int]] = []   # per step: resident lengths

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def delta(self, key: str) -> float:
        return self.c1[key] - self.c0[key]

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 < t <= self.t1

    def window_flops(self) -> float:
        """What the window's tokens need: each prompt whose first token
        came in the window, whole, and each decoded token of the window."""
        s, total = self.sizes, 0.0
        for r in self.requests:
            if self.in_window(r.first):
                total += counts.prompt_flops(s, len(r.prompt))
            for j in range(1, len(r.stamps)):
                if self.in_window(r.stamps[j]):
                    total += counts.decode_flops(s, len(r.prompt) + j - 1)
        return total


def describe(run: Run) -> str:
    """Percentiles of the window's gaps and waits, for the log."""
    out = []
    levels = (50, 80, 85, 90, 93, 95, 97, 98, 99, 99.5)
    for name, xs in (("gap", stats.window_gaps(run)),
                     ("ttft", stats.window_ttfts(run))):
        qs = [stats.percentile(xs, q) for q in levels]
        out.append(f"{name} n={len(xs)} p{'/'.join(map(str, levels))} ms "
                   + "/".join("-" if q is None else f"{1e3 * q:.2f}"
                              for q in qs))
    out.append("ttfts ms " + " ".join(
        f"{1e3 * t:.0f}" for t in sorted(stats.window_ttfts(run))))
    return "; ".join(out)


def snapshot(engine) -> Dict[str, float]:
    m = engine.metrics
    return {k: float(m[k]) for k in COUNTERS}


# --------------------------------------------------------------------------
# correctness
# --------------------------------------------------------------------------

def pick_sample(reqs: List[Req], since: float, tokens: int, seed: int
                ) -> List[Req]:
    """Requests finished after ``since``, drawn from the seed: the one with
    the most positions first, then others until ``tokens`` served tokens."""
    done = sorted((r for r in reqs if r.done is not None and r.done > since),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(
        traffic_lib.seed_words(seed, traffic_lib.SAMPLE_STREAM))
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= tokens:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def served_gaps(cfg: Dict, weights, sample: List[Req], device,
                control: bool = False) -> Dict[str, float]:
    """Run the reference over each sampled prompt with its served tokens;
    per served token, the gap by which its reference logit lies below the
    reference's best.  With ``control``, the fp8 control takes the
    program's place: at each position of the same prompts and served
    tokens, the token it puts first is judged instead, and the program's
    own readings are kept beside under ``program_*``."""
    import torch
    Reference = module(cfg["reference"]).Reference
    seqs, rows, served = [], [], []
    for r in sample:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        P = len(r.prompt)
        seqs.append(torch.as_tensor(toks, device=device))
        rows.append(torch.arange(P - 1, P - 1 + len(r.tokens), device=device))
        served.append(torch.as_tensor(r.tokens, device=device).long())
    ref = Reference(cfg, weights).logits(seqs, rows)

    def reading(tokens) -> Dict[str, float]:
        g = torch.cat([lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
                       for lg, t in zip(ref, tokens)])
        return {"widest_gap": float(g.max()), "tokens": int(g.numel()),
                "not_first": int((g > 0).sum()),
                "gap_p99": float(torch.quantile(g, 0.99))}

    if not control:
        return reading(served)
    ctl = Reference(cfg, weights, precision="fp8").logits(seqs, rows)
    out = reading([c.argmax(-1) for c in ctl])
    del ctl
    out.update({f"program_{k}": v for k, v in reading(served).items()
                if k != "tokens"})
    return out


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sweep_warmup(engine, clients: "Clients", cell: Cell, seed: int) -> None:
    """The warm-up's sweep of the mix's prompt sizes: each sent alone
    (every grant length, fresh and resumed), in groups that fit one step's
    prefill budget (packs) and, with ``fill_sweep``, behind a filler
    (grants cut at the budget's remainder).  The closed loop on the
    warm-up stream follows it in ``run_cell``."""
    warm = cell.settings["warmup"]
    vocab = counts.Sizes(cell.cfg).vocab
    budget = int(cell.settings["engine"]["prefill_token_budget"])
    most = min(4, clients.n)
    for prompts in traffic_lib.sweep(cell.mix, vocab, seed,
                                     int(warm["sweep_sizes"]), most):
        # alone, then in groups of 2 and 4 that one step's budget holds
        k = 1
        while k <= most and (k == 1 or k * len(prompts[0]) <= budget):
            group = [clients.send_one(p, 2, time.perf_counter(),
                                      traffic_lib.SWEEP_STREAM)
                     for p in prompts[:k]]
            drive(engine, clients,
                  lambda _n, _s: all(r.done is not None for r in group),
                  fill=False)
            k *= 2
        # behind a filler prompt that leaves a quarter, half or three
        # quarters of this size of the step's budget: the grant splits at
        # the budget's remainder and resumes a step later, alone; and, where
        # one step's budget holds the rest beside a fresh prompt of this
        # size, once more with that prompt queued behind it (a pack with a
        # resumed row).  Fillers take other prompts' ids than the grants
        # they stand before, so no prefix is shared.
        for frac in (0.25, 0.5, 0.75) if warm.get("fill_sweep") else ():
            size = len(prompts[0])
            fill = budget - int(size * frac)
            if not 0 < fill < budget:
                continue
            groups = [(prompts[1 % len(prompts)], (prompts[0],))]
            if len(prompts) > 2 and size - (budget - fill) + size <= budget:
                groups.append((prompts[2], (prompts[0], prompts[1])))
            for ids, grants in groups:
                filler = np.resize(ids, fill).astype(np.int32)
                group = [clients.send_one(p, 2, time.perf_counter(),
                                          traffic_lib.SWEEP_STREAM)
                         for p in (filler, *grants)]
                drive(engine, clients,
                      lambda _n, _s: all(r.done is not None for r in group),
                      fill=False)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, control: bool = False):
    """One run; returns the result line's object (``correct`` decided,
    ``checks`` last) and the correctness readings."""
    import torch
    from repro_torch.config import padded_vocab

    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    st = cell.settings
    run = Run(cell)
    vocab = run.sizes.vocab
    params = module(cell.cfg["weights"]).make(
        cell.cfg, seed, device, padded_vocab(model_config(cell.cfg), 1),
        dtype=getattr(torch, cell.cfg.get("torch_dtype", "bfloat16")))
    engine = build_engine(cell, params, device)
    clients = Clients(engine, cell.mix, vocab, seed)

    # warm-up: the sweep, then the closed loop on the warm-up stream until
    # no graph was captured for a span
    warm = st["warmup"]
    t_w = time.perf_counter()
    sweep_warmup(engine, clients, cell, seed)
    swept = engine.graphs
    last = {"graphs": engine.graphs, "t": time.perf_counter()}

    def warm_stop(now, steps):
        if engine.graphs != last["graphs"]:
            last["graphs"], last["t"] = engine.graphs, now
        return (now - last["t"] >= warm["stable_s"]
                or now - t_w >= warm["max_s"])

    drive(engine, clients, warm_stop)
    log(f"[bench] warm-up {time.perf_counter() - t_w:.3f} s, "
        f"{engine.graphs} graphs ({swept} in the sweep; "
        f"{engine.capture_s:.3f} s of capture), "
        f"{len(clients.order)} requests sent")

    # the window
    clients.stream = traffic_lib.WINDOW_STREAM
    graphs0 = engine.graphs
    keys0 = set(getattr(engine, "_prefill_fns", {}))
    run.c0 = snapshot(engine)
    run.t0 = time.perf_counter()
    run.setup_s = time.time() - t_start
    run.t1 = drive(engine, clients, lambda now, _s: now - run.t0 >= seconds)
    run.c1 = snapshot(engine)
    in_window = engine.graphs - graphs0
    new_keys = sorted(set(getattr(engine, "_prefill_fns", {})) - keys0,
                      key=str)
    log(f"[bench] graphs captured inside the window: {in_window} "
        f"(new prefill keys {new_keys})")

    # the traced slice: the same traffic, under torch.profiler
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        import devtrace
        rows: List[List[int]] = []

        def note(got):
            rows.append([len(r.prompt) + j - 1 for r, j in got if j >= 1])

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a = time.perf_counter()
            b = drive(engine, clients,
                      lambda now, s: now - a >= TRACE_SECONDS
                      or s >= TRACE_MAX_STEPS, ranges=True, on_step=note)
        t_read = time.perf_counter()
        run.slice = devtrace.Slice(prof, b - a)
        run.slice_rows = rows
        del prof
        log(f"[bench] traced slice: {len(rows)} steps, {b - a:.3f} s, "
            f"{run.slice.n} device intervals, busy {run.slice.busy_s:.6f} s;"
            f" read in {time.perf_counter() - t_read:.1f} s")
    run.requests = clients.order
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    attempted = sum(1 for r in run.requests
                    if r.stream == traffic_lib.WINDOW_STREAM
                    and run.t0 <= r.sent <= run.t1)

    log(f"[bench] window {run.window_s:.3f} s, {int(run.delta('steps'))} "
        f"steps, {attempted} requests sent, "
        f"{sum(1 for r in run.requests if run.in_window(r.done))} done; "
        + describe(run))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # correctness, once the program's state is freed
    sample = pick_sample(run.requests, run.t0, int(st["check"]["tokens"]),
                         seed)
    del engine, clients
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    found = served_gaps(cell.cfg, params, sample, device, control) \
        if sample else {"widest_gap": float("inf"), "tokens": 0}
    log(f"[bench] reference over {len(sample)} requests, "
        f"{found['tokens']} served tokens, in "
        f"{time.perf_counter() - t_c:.1f} s: {json.dumps(found)}")
    limit = float(st["check"]["widest_gap_limit"])
    checks = {"widest_gap": {"value": found["widest_gap"], "limit": limit},
              "served_tokens_checked": {"value": found["tokens"],
                                        "limit": int(st["check"]["tokens"])}}
    correct = (found["widest_gap"] <= limit
               and found["tokens"] >= int(st["check"]["tokens"]))
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if on_card else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace and run.slice is not None:
        result["device"]["busy_s"] = run.slice.busy_s
        result["device"]["window_s"] = run.slice.wall_s
        result["breakdown"] = run.slice.breakdown()
    result["checks"] = checks
    found["graphs_in_window"] = in_window
    return result, found
