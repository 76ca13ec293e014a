"""Measured alpha-beta cost model: profiled tables drive serving decisions
(port of ``repro/perf/costmodel.py``).

The table's sweeps:

  * ``measure_alpha_beta`` — timed all-reduce sweeps over message sizes
    through the ``TPGroup``'s collective (a local element-wise touch at
    tp=1, ``"collective": "local"``), the device synchronised inside the
    timed region, least-squares fit of ``t(n) = alpha + beta * n``;
  * ``measure_prefill_buckets`` — time of the engine's own prefill closures
    per (grant bucket x row bucket);
  * ``measure_decode_depths`` — time of the decode closures per (K, S) over
    page-depth buckets (K = verify-window width, S = split-KV span count).

The closures timed are the ones the engine runs: on the card at tp=1 each
is a CUDA graph and a timed call is one replay (an eager closure there is
host-bound, and a table measured eagerly would price every step by its
launches).  ``autotune`` packages the three sweeps into a versioned
per-platform JSON table (``src/repro_torch/perf/tables/<platform>_tp<tp>.json``,
the platform from ``device.platform_name``), and ``CostModel`` turns a
loaded table into the four serving decisions:

  * ``decode_splits``  — S for the paged decode walk, by modeled time;
  * ``grant_cap``      — prefill chunk size, by modeled time per token;
  * ``pack_rows``      — pack width of batched prefill grants, by modeled
    time per grant;
  * ``spec_worth``     — speculate or not: modeled verify cost against the
    expected accept length (the engine's ``accept_len`` histogram).

The pure parts (``fit_linear``, ``_interp``, ``validate_table``,
``CostModel``, ``load_cost_model``) are the reference's, with the same
float operations in the same order, so decisions equal the reference's on
any table.  Every failure to load a table falls back to the static
defaults with a single ``warning`` trace event, and each model-driven
decision is logged as a ``decision`` event (point, chosen, static, inputs).
Decisions are pure table lookups, no clocks, so a fixed table and traffic
give a fixed decision sequence.

    python -m repro_torch.perf.costmodel --validate T.json
    python -m repro_torch.perf.costmodel --autotune --arch qwen3-8b \\
        --preset full --out T.json          # on the card
"""
from __future__ import annotations

import json
import math
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import platform_name, synchronize

SCHEMA = "costmodel-v1"
TABLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables")

# message sizes (bytes) for the alpha-beta sweep
AB_SIZES = (1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 21)
AB_SIZES_SMOKE = (1 << 10, 1 << 16, 1 << 20)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _median_fenced(call, iters: int, warmup: int, device) -> float:
    """Median seconds of ``call()`` with the device synchronised inside the
    timed region, so the time is execution, never enqueue."""
    for _ in range(max(1, warmup)):
        call()
        synchronize(device)
    samples = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        call()
        synchronize(device)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def fit_linear(samples: Sequence[Tuple[float, float]]) -> Tuple[float, float, float]:
    """Least-squares fit ``t = alpha + beta * x`` over (x, t) samples.

    Returns (alpha, beta, r2); alpha is clamped at >= 0 (a negative
    intercept is measurement noise, and a negative latency would make every
    downstream time estimate nonsense).  Degenerate inputs (one point, or
    all x equal) fit beta = 0.
    """
    xs = [float(x) for x, _ in samples]
    ts = [float(t) for _, t in samples]
    n = len(xs)
    assert n >= 1, "fit_linear needs at least one sample"
    mx, mt = sum(xs) / n, sum(ts) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if n < 2 or sxx == 0.0:
        return max(0.0, mt), 0.0, 1.0
    sxt = sum((x - mx) * (t - mt) for x, t in zip(xs, ts))
    beta = sxt / sxx
    alpha = mt - beta * mx
    stt = sum((t - mt) ** 2 for t in ts)
    if stt == 0.0:
        r2 = 1.0
    else:
        ss_res = sum((t - (alpha + beta * x)) ** 2 for x, t in zip(xs, ts))
        r2 = 1.0 - ss_res / stt
    return max(0.0, alpha), max(0.0, beta), r2


def measure_alpha_beta(group=None, sizes: Sequence[int] = AB_SIZES,
                       iters: int = 8, warmup: int = 3,
                       device=None) -> Dict[str, Any]:
    """Profile the group's all-reduce: latency (alpha, s) and inverse
    bandwidth (beta, s/byte) from a timed sweep over message sizes.

    With ``group`` (a ``launch.mesh.TPGroup``; every rank calls this), each
    probe is one fp32 all-reduce over it, the collective the serving stack
    issues.  Without one there is no wire: the sweep times an element-wise
    touch of the same buffers on ``device``, so alpha captures launch
    latency and beta the memory system's inverse bandwidth, a degenerate
    stand-in that keeps the table schema the same everywhere."""
    import torch

    from repro_torch.core.overlap import psum_now

    dev = group.device if group is not None else torch.device(device or "cpu")
    ctx = group.axis_ctx() if group is not None else None
    isz = torch.zeros((), dtype=torch.float32).element_size()
    samples = []
    raw = []
    for nbytes in sizes:
        n = max(1, int(nbytes) // isz)
        x = torch.zeros((n,), dtype=torch.float32, device=dev)
        if ctx is not None:
            def call(x=x):
                return psum_now(x, ctx)
        else:
            def call(x=x):
                return x + 1.0
        t = _median_fenced(call, iters, warmup, dev)
        actual = n * isz
        samples.append((actual, t))
        raw.append({"bytes": int(actual), "t_s": t})
    alpha, beta, r2 = fit_linear(samples)
    return {"alpha_s": alpha, "beta_s_per_byte": beta, "r2": r2,
            "collective": "psum" if group is not None else "local",
            "samples": raw}


def _check_idle(engine) -> None:
    """The probes write KV into the pool pages their fake block tables
    name (the port's closures scatter in place), so they run on an engine
    that holds no request."""
    if engine.alloc.tables or engine._by_rid:
        raise RuntimeError("cost-model probes need an idle engine: they "
                           "write into the pool pages they time")


def measure_prefill_buckets(engine, buckets: Optional[Sequence[int]] = None,
                            rows: Optional[Sequence[int]] = None,
                            iters: int = 3, warmup: int = 1
                            ) -> Dict[str, float]:
    """Time (us) of the engine's own prefill closures per (grant bucket x
    row bucket), keyed ``"<T>x<R>"``.

    Inputs are synthetic: zero tokens, every row resuming after a one-page
    resident prefix through a fake block table over the first pool pages,
    so the paged prefill kernel runs.  The closure writes that KV into
    those pages; its logits are discarded."""
    _check_idle(engine)
    buckets = tuple(buckets if buckets is not None
                    else (engine._buckets or (engine.sv.prefill_token_budget,)))
    rows = tuple(rows if rows is not None else engine._row_buckets)
    ps, MB = engine.ps, engine.max_blocks
    out: Dict[str, float] = {}
    for T in buckets:
        for R in rows:
            if R > 1 and not engine._batch_prefill:
                continue
            need = -(-(ps + T) // ps)
            if R * need > engine.alloc.num_pages or need > MB:
                continue
            bt = np.full((R, MB), -1, np.int32)
            for r in range(R):
                bt[r, :need] = np.arange(r * need, (r + 1) * need,
                                         dtype=np.int32)
            if engine._batch_prefill:
                fn = engine._get_prefill_batched(T, R, all_fresh=False)
                host = dict(tokens=np.zeros((R, T), np.int32), bt=bt,
                            starts=np.full(R, ps, np.int32),
                            n_reals=np.full(R, T, np.int32))
            else:
                fn = engine._get_prefill(T, resumed=True)
                host = dict(tokens=np.zeros((1, T), np.int32), bt=bt[:1],
                            start=ps, n_real=T)
            engine._compile(fn, host)
            fn.stage(**host)
            out[f"{T}x{R}"] = _median_fenced(fn, iters, warmup,
                                             engine.device) * 1e6
    return out


def measure_decode_depths(engine, Ks: Sequence[int] = (1,),
                          Ss: Sequence[int] = (1, 2, 4),
                          depths: Sequence[int] = (2, 8),
                          iters: int = 3, warmup: int = 1
                          ) -> Dict[str, float]:
    """Time (us) of decode closures per (K, S) over page-depth buckets,
    keyed ``"<K>/<S>/<pages>"``: every slot decoding at the same depth.
    The closures are built directly (``_build_decode_fn``) and kept here,
    so ``engine._decode_fns`` stays pinned to real traffic."""
    _check_idle(engine)
    B, ps, MB = engine.max_batch, engine.ps, engine.max_blocks
    fns: Dict[Tuple[int, int], Any] = {}
    out: Dict[str, float] = {}
    for depth in depths:
        d = min(int(depth), MB, max(1, engine.alloc.num_pages // B))
        L = d * ps - max(Ks)                   # window fits in the last page
        if L <= 0:
            continue
        bt = np.full((B, MB), -1, np.int32)
        for b in range(B):
            bt[b, :d] = np.arange(b * d, (b + 1) * d, dtype=np.int32)
        lens = np.full((B,), L, np.int32)
        mask = np.ones((B,), bool)
        for K in Ks:
            toks = np.zeros((B, K), np.int32)
            for S in Ss:
                if S > d:
                    continue                   # span wider than the walk
                if (K, S) not in fns:
                    fns[(K, S)] = engine._build_decode_fn(
                        K, S, engine._decode_schedule)
                fn = fns[(K, S)]
                host = dict(toks=toks, lengths=lens, bt=bt, mask=mask)
                engine._compile(fn, host)
                fn.stage(**host)
                out[f"{K}/{S}/{d}"] = _median_fenced(fn, iters, warmup,
                                                     engine.device) * 1e6
    return out


# ---------------------------------------------------------------------------
# autotune: measurements -> versioned per-platform table
# ---------------------------------------------------------------------------

def autotune(config, params, mesh=None, *, smoke: bool = False, device=None,
             Ks: Optional[Sequence[int]] = None,
             log=lambda msg: None) -> Dict[str, Any]:
    """Run the offline profile for ``config`` on ``device`` (the card unless
    the CPU is asked for; ``mesh``'s device under TP) and return a
    schema-valid cost table (see ``validate_table``).

    Builds a throwaway ``PagedEngine`` with its own page pool (and on the
    card its own CUDA graphs), sweeps the alpha-beta probe and both closure
    timing grids, and stamps platform and mesh so loaders refuse a table
    measured elsewhere.  ``smoke`` shrinks every sweep to a small subset
    (same schema, fewer points).  Beside the schema's keys the table names
    the device and the engine settings it was measured at.  Under TP every
    rank calls this and gets rank 0's table."""
    import torch

    from repro_torch.serving.paged_engine import PagedEngine

    engine = PagedEngine(config, params, mesh=mesh, device=device)
    sv = config.serving
    spec_K = (sv.spec_k + 1) if sv.spec_k else 3
    Ks = tuple(Ks) if Ks else (1, spec_K)
    if smoke:
        ab_sizes, ab_iters = AB_SIZES_SMOKE, 5
        buckets = (engine._buckets or (64,))[:3]
        rows = tuple(r for r in engine._row_buckets if r <= 4)
        Ss, depths, k_iters = (1, 2, 4), (2, 8), 3
    else:
        ab_sizes, ab_iters = AB_SIZES, 8
        buckets, rows = engine._buckets, engine._row_buckets
        Ss = (1, 2, 4, 8)
        depths = tuple(sorted({2, 4, 8, 16, min(32, engine.max_blocks)}))
        k_iters = 5
    log(f"alpha-beta sweep: {len(ab_sizes)} sizes, mesh={'yes' if mesh else 'no'}")
    ab = measure_alpha_beta(mesh, sizes=ab_sizes, iters=ab_iters,
                            device=engine.device)
    log(f"  alpha={ab['alpha_s']:.3e}s beta={ab['beta_s_per_byte']:.3e}s/B "
        f"r2={ab['r2']:.3f}")
    log(f"prefill sweep: buckets={tuple(buckets or ())} rows={rows}")
    prefill = measure_prefill_buckets(engine, buckets=buckets, rows=rows,
                                      iters=k_iters)
    log(f"decode sweep: K={Ks} S={Ss} depths={depths}")
    decode = measure_decode_depths(engine, Ks=Ks, Ss=Ss, depths=depths,
                                   iters=k_iters)
    dev = engine.device
    table = {
        "schema": SCHEMA,
        "version": 1,
        "platform": platform_name(dev),
        "mesh": {"tp": engine.tp},
        "model": config.model.name,
        "page_size": engine.ps,
        "alpha_beta": ab,
        "prefill_us": prefill,
        "decode_us": decode,
        # outside the schema: what the table was measured on and at
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "dtype": str(params["embed"]["table"].dtype).replace("torch.", ""),
        "graphed": engine._graphed,
        "engine": {"max_batch": sv.max_batch, "max_len": sv.max_len,
                   "prefill_token_budget": sv.prefill_token_budget,
                   "spec_k": sv.spec_k, "prefill_batching": sv.prefill_batching,
                   "smoke": smoke},
        "decode_depths_pages": [min(depths), max(depths)],
    }
    if mesh is not None:
        # each rank timed its own closures; every rank must take the same
        # decisions (they pick the closures whose collectives meet), so all
        # serve with rank 0's table
        import torch.distributed as dist
        box = [table]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        table = box[0]
    return table


# ---------------------------------------------------------------------------
# table schema
# ---------------------------------------------------------------------------

def validate_table(doc: Any) -> List[str]:
    """Structural validation of a cost table; returns problems (empty=valid).
    ``write_table`` refuses to write, and ``load_cost_model`` refuses
    (-> static defaults) anything that fails.  Keys outside the schema
    (the card's name and power limit, the engine settings a table was
    measured at) are ignored."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["table is not a JSON object"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, want {SCHEMA!r}")
    if not isinstance(doc.get("version"), int) or doc.get("version", 0) < 1:
        problems.append("version must be an int >= 1")
    if not isinstance(doc.get("platform"), str) or not doc.get("platform"):
        problems.append("platform must be a non-empty string")
    mesh = doc.get("mesh")
    if not (isinstance(mesh, dict) and isinstance(mesh.get("tp"), int)
            and mesh["tp"] >= 1):
        problems.append("mesh.tp must be an int >= 1")
    ab = doc.get("alpha_beta")
    if not isinstance(ab, dict):
        problems.append("alpha_beta missing")
    else:
        for k in ("alpha_s", "beta_s_per_byte"):
            v = ab.get(k)
            if not isinstance(v, (int, float)) or not math.isfinite(v) or v < 0:
                problems.append(f"alpha_beta.{k} must be a finite number >= 0")
    for section, nkeys in (("prefill_us", 2), ("decode_us", 3)):
        d = doc.get(section)
        if not isinstance(d, dict):
            problems.append(f"{section} missing")
            continue
        for key, v in d.items():
            parts = key.replace("x", "/").split("/")
            ok = len(parts) == nkeys and all(p.isdigit() and int(p) >= 1
                                             for p in parts)
            if not ok:
                problems.append(f"{section}[{key!r}]: malformed key")
            if not isinstance(v, (int, float)) or not math.isfinite(v) or v <= 0:
                problems.append(f"{section}[{key!r}]: timing must be > 0")
    return problems


def default_table_path(platform: str, tp: int) -> str:
    return os.path.join(TABLES_DIR, f"{platform}_tp{tp}.json")


def write_table(doc: Dict[str, Any], path: str) -> str:
    problems = validate_table(doc)
    assert not problems, f"refusing to write an invalid cost table: {problems}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# the model: pure table lookups -> serving decisions
# ---------------------------------------------------------------------------

def _interp(points: Sequence[Tuple[int, float]], x: int) -> float:
    """Piecewise-linear interpolation over sorted (x, y); clamps below the
    first point, extrapolates the last segment's slope above the last (a
    deeper page walk keeps paying the per-page marginal cost)."""
    if len(points) == 1:
        return points[0][1]
    if x <= points[0][0]:
        return points[0][1]
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        if x <= x1:
            return y0 + (y1 - y0) * (x - x0) / (x1 - x0)
    (x0, y0), (x1, y1) = points[-2], points[-1]
    return max(0.0, y1 + (y1 - y0) * (x - x1) / (x1 - x0))


class CostModel:
    """Serving decisions from a measured cost table.

    Every method is a pure function of the table and its arguments — no
    clocks, no randomness — so a fixed table and traffic stream produce a
    deterministic decision sequence.  Every method returns ``None`` when the
    table lacks the data to decide; callers then use the static default
    (the graceful-degradation contract tests/test_torch_costmodel.py
    pins).
    """

    def __init__(self, table: Dict[str, Any]):
        problems = validate_table(table)
        if problems:
            raise ValueError(f"invalid cost table: {problems[:3]}")
        self.table = table
        self.platform: str = table["platform"]
        self.tp: int = table["mesh"]["tp"]
        ab = table["alpha_beta"]
        self.alpha_s: float = float(ab["alpha_s"])
        self.beta_s_per_byte: float = float(ab["beta_s_per_byte"])
        # decode_us "K/S/pages" -> {(K, S): sorted [(pages, us)]}
        self._decode: Dict[Tuple[int, int], List[Tuple[int, float]]] = {}
        for key, us in table["decode_us"].items():
            k, s, d = (int(p) for p in key.split("/"))
            self._decode.setdefault((k, s), []).append((d, float(us)))
        for pts in self._decode.values():
            pts.sort()
        # prefill_us "TxR" -> {T: {R: us}}
        self._prefill: Dict[int, Dict[int, float]] = {}
        for key, us in table["prefill_us"].items():
            t, r = (int(p) for p in key.split("x"))
            self._prefill.setdefault(t, {})[r] = float(us)

    @classmethod
    def from_file(cls, path: str) -> "CostModel":
        with open(path) as f:
            return cls(json.load(f))

    def matches(self, platform: str, tp: int) -> bool:
        return self.platform == platform and self.tp == tp

    # ---- primitives -------------------------------------------------------
    def collective_s(self, nbytes: int) -> float:
        """Modeled all-reduce time for an ``nbytes`` message (alpha-beta)."""
        return self.alpha_s + self.beta_s_per_byte * max(0, nbytes)

    def decode_us(self, K: int, S: int, depth_pages: int) -> Optional[float]:
        pts = self._decode.get((K, S))
        if not pts:
            return None
        return _interp(pts, max(1, depth_pages))

    def prefill_us(self, bucket: int, rows: int = 1) -> Optional[float]:
        return self._prefill.get(bucket, {}).get(rows)

    # ---- decisions --------------------------------------------------------
    def decode_splits(self, depth_pages: int, K: int = 1,
                      max_splits: int = 0) -> Optional[int]:
        """Split count S minimising modeled decode time at this page depth.
        Ties break toward the smaller S (less reduce work, fewer compiled
        closures).  None when the table has no timings for this K."""
        cands = sorted(s for (k, s) in self._decode if k == K)
        if max_splits:
            cands = [s for s in cands if s <= max_splits]
        best, best_t = None, float("inf")
        for s in cands:
            if s > max(1, depth_pages):
                continue                      # span wider than the walk
            t = self.decode_us(K, s, depth_pages)
            if t is not None and t < best_t:
                best, best_t = s, t
        return best

    def grant_cap(self, buckets: Optional[Sequence[int]] = None
                  ) -> Optional[int]:
        """Prefill chunk cap (tokens per grant): the bucket with the best
        modeled time-per-token at row width 1.  A bigger grant past this
        bucket buys no amortisation the measurements can see.  None when no
        single-row bucket was measured (or ``buckets`` filters them out)."""
        best, best_eff = None, float("inf")
        for t, by_rows in sorted(self._prefill.items()):
            if buckets is not None and t not in buckets:
                continue
            us = by_rows.get(1)
            if us is None:
                continue
            eff = us / t
            if eff < best_eff:
                best, best_eff = t, eff
        return best

    def pack_rows(self, padded: int) -> Optional[int]:
        """Pack width for batched prefill grants of ``padded`` tokens: the
        measured row bucket with the best modeled time-per-grant, at the
        nearest measured length bucket.  None with no multi-row data."""
        if not self._prefill:
            return None
        t = min(self._prefill, key=lambda b: abs(math.log(b / max(padded, 1))))
        by_rows = self._prefill[t]
        best, best_eff = None, float("inf")
        for r, us in sorted(by_rows.items()):
            eff = us / r
            if eff < best_eff:
                best, best_eff = r, eff
        return best

    def spec_worth(self, K: int, depth_pages: int,
                   expected_accept: float) -> Optional[bool]:
        """Is a K-token speculative verify worth it at this depth, given the
        expected accept length?  Worth when the verify call costs less than
        the ``expected_accept`` plain decode steps it replaces.  None when
        either K's timings are missing from the table."""
        def best_t(k):
            ts = [self.decode_us(k, s, depth_pages)
                  for (kk, s) in self._decode if kk == k]
            ts = [t for t in ts if t is not None]
            return min(ts) if ts else None
        t_verify = best_t(K)
        t_plain = best_t(1)
        if t_verify is None or t_plain is None:
            return None
        return t_verify < max(expected_accept, 1.0) * t_plain


# ---------------------------------------------------------------------------
# loading (the graceful-degradation boundary)
# ---------------------------------------------------------------------------

def load_cost_model(spec: str, *, platform: str, tp: int,
                    trace=None) -> Optional[CostModel]:
    """Resolve ``ServingConfig.cost_table`` into a CostModel, or None.

    ``spec`` is ``"auto"`` (the bundled per-platform table under
    ``perf/tables/``) or an explicit path.  EVERY failure mode — missing
    file, unreadable JSON, schema violation, platform/mesh mismatch — emits
    exactly one ``warning`` trace event and returns None, so the engine
    falls back to its static defaults instead of dying or mis-deciding from
    someone else's measurements.
    """
    path = default_table_path(platform, tp) if spec == "auto" else spec

    def warn(reason: str) -> None:
        if trace is not None:
            trace.emit("warning", what="cost_table", reason=reason, path=path)

    if not os.path.exists(path):
        warn("missing")
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        warn(f"unreadable: {e}")
        return None
    problems = validate_table(doc)
    if problems:
        warn(f"invalid: {problems[0]}")
        return None
    model = CostModel(doc)
    if not model.matches(platform, tp):
        warn(f"mismatch: table is {model.platform}/tp{model.tp}, "
             f"engine is {platform}/tp{tp}")
        return None
    return model


def _nvidia_smi(index: int) -> Tuple[str, str]:
    """(name, power limit) of card ``index`` as nvidia-smi reports them."""
    import subprocess
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={index}"],
                         capture_output=True, text=True, check=True)
    name, limit = res.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


# the settings a bundled table is measured at: those the card's defaults
# pass serves with (chip_smoke.serve_defaults), the ISO split at its default
TABLE_SERVING = dict(page_size=16, max_batch=4, max_len=2048,
                     prefill_token_budget=1024, spec_k=4)


def _autotune_cli(args) -> int:
    import dataclasses

    import torch

    from repro_torch.config import Config, ISOConfig, ParallelConfig, \
        RuntimeConfig, ServingConfig, get_model_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import reduce_cfg
    from repro_torch.models import api

    dev = resolve_device(args.device)
    cfg = reduce_cfg(get_model_config(args.arch), args.preset)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=ISOConfig(), runtime=RuntimeConfig(mode="serve"),
                    serving=ServingConfig(**TABLE_SERVING))
    # random weights from seed 0: the closures' times do not depend on them
    params = api.init_params(0, cfg, tp=1, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    table = autotune(config, params, device=dev,
                     log=lambda msg: print(f"[autotune] {msg}", flush=True))
    seconds = time.perf_counter() - t0
    if dev.type == "cuda":
        table["device"], table["power_limit"] = _nvidia_smi(
            dev.index if dev.index is not None else 0)
    table["engine"] = dict(table["engine"], page_size=config.serving.page_size,
                           iso=dataclasses.asdict(config.iso), seed=0,
                           autotune_s=seconds)
    write_table(table, args.out)
    print(f"{args.out}: {table['platform']}/tp1 {cfg.name} "
          f"({len(table['prefill_us'])} prefill + {len(table['decode_us'])} "
          f"decode points) in {seconds:.1f}s on {table['device']}"
          f"{', ' + table['power_limit'] if 'power_limit' in table else ''}")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--validate", metavar="TABLE.json",
                      help="validate a cost table against the schema")
    what.add_argument("--autotune", action="store_true",
                      help="measure a tp=1 table of --arch in bf16 at "
                           "TABLE_SERVING's settings on --device and write "
                           "it to --out")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--preset", default="full", choices=["tiny", "full"])
    ap.add_argument("--out", metavar="TABLE.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.autotune:
        if not args.out:
            ap.error("--autotune needs --out")
        return _autotune_cli(args)
    with open(args.validate) as f:
        doc = json.load(f)
    problems = validate_table(doc)
    if problems:
        for p in problems:
            print(f"INVALID: {p}")
        return 1
    print(f"{args.validate}: schema-valid {SCHEMA} "
          f"({doc['platform']}/tp{doc['mesh']['tp']}, "
          f"{len(doc['prefill_us'])} prefill + {len(doc['decode_us'])} "
          f"decode points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
