"""Serving-stack observability: typed metrics, structured traces, profiling
(port of ``repro/obs``).

  * ``registry``  — typed counters/gauges/histograms behind a dict-compatible
    ``MetricsView`` so engine code and tests keep their ``metrics["key"]``
    idiom while percentiles/peaks come from real distributions;
  * ``trace``     — a bounded ring of structured ``TraceEvent``s emitted by
    the scheduler (grant/pack/defer), allocator (alloc/free/cow/adopt) and
    engine phase loops (prefill/decode calls, spec verify, preemption);
  * ``export``    — Chrome-trace/Perfetto JSON from the ring, plus schema
    validation;
  * ``replay``    — recompute counters from a trace stream; the conservation
    oracle (trace must reproduce the registry) tests pin;
  * ``torchprof`` — ``Span``: a named stretch of host code timed into
    registry counters always, and marked with a ``torch.profiler`` range of
    its name while any profile records, so device timelines line up with
    the host's phases (``PagedEngine.step``'s ``engine/…`` spans and the
    closure calls' ranges); ``start``/``stop`` of a profile (``jaxprof`` in
    the reference).
"""
from repro_torch.obs.registry import (ACCEPT_LEN_BUCKETS, TPOT_BUCKETS_S,
                                      TTFT_BUCKETS_S, Counter, Gauge,
                                      Histogram, MetricsRegistry,
                                      MetricsView)
from repro_torch.obs.trace import TraceEvent, TraceRing
from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.replay import replay_counters

__all__ = [
    "ACCEPT_LEN_BUCKETS", "TPOT_BUCKETS_S", "TTFT_BUCKETS_S", "Counter",
    "Gauge", "Histogram", "MetricsRegistry", "MetricsView", "TraceEvent",
    "TraceRing", "chrome_trace", "validate_chrome_trace",
    "write_chrome_trace", "replay_counters",
]
