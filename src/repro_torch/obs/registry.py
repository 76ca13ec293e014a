"""Typed metrics: counters, gauges, histograms behind a dict-compatible view
(copy of ``repro/obs/registry.py``).

The engines used to keep a raw ``self.metrics`` dict — fine for sums, useless
for distributions (a TTFT *mean* hides the p99 the scheduler actually
degrades).  This module keeps the dict IDIOM (``metrics["decode_tokens"] += n``
still works, every existing test reads unchanged) while the storage becomes
typed instruments:

  * ``Counter``   — monotonically-growing scalar (float or int);
  * ``Gauge``     — last-set value, with the running peak tracked for free;
  * ``Histogram`` — fixed bucket ladder (upper edges), O(1) observe, and
    bucket-interpolated percentiles.  Ladders are FIXED per quantity
    (``TTFT_BUCKETS_S`` etc.) so histograms from different runs/engines are
    mergeable bucket-by-bucket — the Prometheus rule.

``MetricsRegistry.view()`` returns the MutableMapping the engines expose as
``.metrics``.  Scalars (counters and gauges) live in one namespace; histograms
are reached through the registry only (``registry.histogram("ttft")``) — a
distribution has no single scalar value to impersonate.

Pure Python: observe/inc are a dict lookup and an add, so keeping the
registry always on costs nanoseconds against millisecond-scale step calls.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterator, List, MutableMapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# fixed bucket ladders (upper edges, ascending; +inf overflow bucket implied)
# ---------------------------------------------------------------------------

# time-to-first-token, seconds: 0.5ms .. 10s, ~geometric
TTFT_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5,
    1.0, 2.0, 5.0, 10.0)

# time-per-output-token, seconds: 0.1ms .. 1s
TPOT_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0)

# tokens accepted per speculative verify call (K is small)
ACCEPT_LEN_BUCKETS: Tuple[float, ...] = (1, 2, 3, 4, 6, 8, 12, 16)


class Counter:
    """Monotonic scalar.  ``set`` exists only for the legacy dict view."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-set value; the running peak comes along for free."""
    __slots__ = ("name", "value", "peak")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.peak = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value}, peak={self.peak})"


class Histogram:
    """Fixed-ladder histogram: ``edges`` are ascending upper bounds; bucket i
    counts observations <= edges[i] (and > edges[i-1]); one overflow bucket
    catches the rest.  ``percentile`` interpolates linearly inside the bucket
    the rank falls in, clamped by the observed min/max so tiny samples don't
    report a bucket edge nobody hit."""
    __slots__ = ("name", "edges", "counts", "n", "sum", "min", "max")

    def __init__(self, name: str, edges: Sequence[float]):
        assert edges and list(edges) == sorted(edges), \
            f"histogram {name}: edges must be ascending, got {edges}"
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.n = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 1].  0.0 with no observations."""
        if not self.n:
            return 0.0
        assert 0.0 <= q <= 1.0, q
        rank = q * self.n
        seen = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                lo = self.edges[i - 1] if i > 0 else min(self.min, self.edges[0])
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {"n": self.n, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.n else 0.0,
                "max": self.max if self.n else 0.0,
                "p50": self.percentile(0.50), "p90": self.percentile(0.90),
                "p99": self.percentile(0.99)}

    def __repr__(self) -> str:
        return (f"Histogram({self.name}: n={self.n} mean={self.mean:.4g} "
                f"p50={self.percentile(0.5):.4g} "
                f"p99={self.percentile(0.99):.4g})")


class MetricsView(MutableMapping):
    """The engines' ``.metrics``: a MutableMapping over the registry's scalar
    namespace.  ``m[k] += 1`` and ``m[k] = max(m[k], v)`` hit Counter/Gauge
    storage; missing keys raise KeyError like the dict did (engines
    pre-register their key set, so a typo'd metric name still fails loudly)."""

    def __init__(self, registry: "MetricsRegistry"):
        self._r = registry

    def __getitem__(self, key: str):
        return self._r._scalars[key].value

    def __setitem__(self, key: str, value) -> None:
        s = self._r._scalars.get(key)
        if s is None:
            s = self._r.counter(key)
        s.set(value)

    def __delitem__(self, key: str) -> None:
        del self._r._scalars[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._r._scalars)

    def __len__(self) -> int:
        return len(self._r._scalars)

    def __repr__(self) -> str:
        return repr({k: s.value for k, s in self._r._scalars.items()})


class MetricsRegistry:
    """Create-on-first-use instrument store.  One per engine."""

    def __init__(self):
        self._scalars: Dict[str, object] = {}     # Counter | Gauge
        self._hists: Dict[str, Histogram] = {}
        self._view = MetricsView(self)

    # ---- instruments ------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._scalars.get(name)
        if c is None:
            c = self._scalars[name] = Counter(name)
        assert isinstance(c, Counter), f"{name} is {type(c).__name__}"
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._scalars.get(name)
        if g is None:
            g = self._scalars[name] = Gauge(name)
        assert isinstance(g, Gauge), f"{name} is {type(g).__name__}"
        return g

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            assert edges is not None, \
                f"histogram {name} not registered and no edges given"
            h = self._hists[name] = Histogram(name, edges)
        return h

    def counters(self, names: Sequence[str]) -> None:
        """Pre-register a key set so ``view[k]`` never KeyErrors for it and
        ``== 0`` assertions hold before first increment."""
        for n in names:
            self.counter(n)

    # ---- access -----------------------------------------------------------
    def view(self) -> MetricsView:
        return self._view

    @property
    def histograms(self) -> Dict[str, Histogram]:
        return dict(self._hists)

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-ready dump: scalars by name, gauges add ``name_peak``,
        histograms add ``name_{n,sum,mean,min,max,p50,p90,p99}``."""
        out: Dict[str, object] = {}
        for name, s in self._scalars.items():
            out[name] = s.value
            if isinstance(s, Gauge):
                out[name + "_peak"] = s.peak
        for name, h in self._hists.items():
            for k, v in h.snapshot().items():
                out[f"{name}_{k}"] = v
        return out
