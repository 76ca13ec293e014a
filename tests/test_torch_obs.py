"""The port's observability package (``repro_torch.obs``) and its narration
in ``PagedEngine``, held against the reference's ``repro.obs`` and the JAX
engine, fp32 on the CPU at the ``tiny_dense`` size.

  * the registry (counters, gauges, the fixed-ladder histograms and their
    percentiles), the trace ring (bounds, drops, the disabled ring), the
    Chrome-trace export and its validator, and ``replay_counters`` fed the
    same sequences as the reference's modules give equal results;
  * on traffic that preempts, shares prefixes (adopting, copying on write,
    deferring a packmate, packing) and speculates (``spec_k=2``), the port
    engine's event stream equals the JAX engine's as (kind, rid, slot,
    payload without timings): the same events at the same points of the
    host loop.  The reference invalidates rejected verify positions in its
    ``pos`` pool, which the port lacks; both narrate it as one
    ``spec_rollback`` with the same count.  Replaying the port's trace
    gives its registry's counters, its metric keys equal the reference's
    (less the gauges and histograms nothing in the port reads, plus the
    step's span counters), its histograms equal the reference's where they
    count (``tpot`` holds times: its sample counts are compared);
  * ``observability=False`` silences the ring and leaves the registry;
  * two gloo ranks at tp=2 narrate equal streams;
  * ``torchprof.start`` records a CPU profile of an engine run holding its
    closure names and its step's ``engine/…`` phase ranges (the spans
    themselves: tests/test_torch_spans.py)."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro import obs as r_obs  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.obs.replay import REPLAYABLE as R_REPLAYABLE  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge, obs  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import serve_rank  # noqa: E402
from repro_torch.obs import torchprof  # noqa: E402
from repro_torch.obs.replay import REPLAYABLE  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
# payload keys that hold wall-clock readings
TIMING_KEYS = ("us",)
# the port's own counters (the step's phase spans, the wait before a first
# prefill call, the sampled rows picked on the device or the host), and the
# reference's instruments the port does not keep since nothing reads them
PORT_ONLY = {"step_s", "prep_s", "logits_copy_s", "sample_s", "grant_wait_s",
             "grant_wait_n", "sampled_rows_device", "sampled_rows_host"}
REF_ONLY = {"pool_occupancy", "free_list_fragmentation"}
REF_ONLY_HISTOGRAMS = {"ttft", "grant_size"}
# every kind the two traffic cases below must narrate between them
KINDS = {"admit", "grant", "pack", "defer", "grant_commit", "prefill_call",
         "sample", "decode_call", "accept", "spec_rollback", "evict",
         "finish", "pool", "alloc", "free", "cow", "adopt", "rc_drop"}


# ---------------------------------------------------------------------------
# the pure modules, fed the same sequences
# ---------------------------------------------------------------------------

LADDERS = [("TTFT_BUCKETS_S", "ttft"), ("TPOT_BUCKETS_S", "tpot"),
           ("ACCEPT_LEN_BUCKETS", "accept")]


@pytest.mark.parametrize("ladder,name", LADDERS, ids=[n for _, n in LADDERS])
def test_registry_equals_reference(ladder, name):
    assert getattr(obs, ladder) == getattr(r_obs, ladder)
    edges = getattr(obs, ladder)
    rng = np.random.default_rng(len(name))
    # values across and past the ladder, the edges themselves included
    vals = list(rng.uniform(0, edges[-1] * 1.5, 300)) + list(edges) + \
        [0.0, edges[-1] * 4]
    regs = (obs.MetricsRegistry(), r_obs.MetricsRegistry())
    for r in regs:
        r.counters(("steps", "decode_tokens"))
        h = r.histogram(name, edges)
        g = r.gauge("pool")
        m = r.view()
        for i, v in enumerate(vals):
            h.observe(v)
            g.set(int(v) % 17)
            m["steps"] += 1
            m["decode_tokens"] = max(m["decode_tokens"], i % 11)
    port, ref = regs
    assert port.snapshot() == ref.snapshot()
    hp, hr = port.histogram(name), ref.histogram(name)
    assert hp.counts == hr.counts
    for q in np.linspace(0, 1, 41):
        assert hp.percentile(q) == hr.percentile(q)
    assert dict(port.view()) == dict(ref.view())
    with pytest.raises(KeyError):
        port.view()["nope"]
    with pytest.raises(AssertionError):
        port.gauge("steps")                    # a counter, not a gauge


def _emit_all(ring, rng, n):
    kinds = ("grant", "alloc", "prefill_call", "decode_call", "accept",
             "pool", "finish", "decision")
    for i in range(n):
        k = kinds[int(rng.integers(len(kinds)))]
        kw = dict(ts=float(i) * 1e-4)
        if k in ("prefill_call", "decode_call"):
            kw["dur"] = float(rng.uniform(1e-5, 1e-3))
        if k == "pool":
            ring.emit(k, used=int(rng.integers(9)), free=3, frag=2, **kw)
        else:
            ring.emit(k, rid=int(rng.integers(-1, 4)),
                      slot=int(rng.integers(-1, 3)), n=int(rng.integers(5)),
                      **kw)


@pytest.mark.parametrize("capacity,n", [(1000, 300), (64, 300), (1, 5)])
def test_trace_ring_export_and_replay_equal_reference(capacity, n):
    rings = (obs.TraceRing(capacity), r_obs.TraceRing(capacity))
    for ring in rings:
        _emit_all(ring, np.random.default_rng(capacity), n)
    port, ref = rings
    assert (len(port), port.dropped) == (len(ref), ref.dropped)
    assert port.dropped == max(0, n - capacity)
    assert [(e.ts, e.kind, e.rid, e.slot, e.dur, e.payload)
            for e in port.events()] == \
        [(e.ts, e.kind, e.rid, e.slot, e.dur, e.payload)
         for e in ref.events()]
    doc = obs.chrome_trace(port.events())
    assert doc == r_obs.chrome_trace(ref.events())
    assert obs.validate_chrome_trace(doc) == []
    assert r_obs.validate_chrome_trace(doc) == []
    assert obs.replay_counters(port.events()) == \
        r_obs.replay_counters(ref.events())
    assert REPLAYABLE == R_REPLAYABLE
    off = obs.TraceRing(capacity, enabled=False)
    _emit_all(off, np.random.default_rng(0), n)
    assert len(off) == 0 and off.dropped == 0


def test_chrome_trace_validators_agree_on_bad_docs(tmp_path):
    ring = obs.TraceRing()
    _emit_all(ring, np.random.default_rng(5), 40)
    path = tmp_path / "t.json"
    n = obs.write_chrome_trace(ring.events(), str(path))
    doc = json.loads(path.read_text())
    assert n == sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
    bad = [None, {"traceEvents": 3},
           {"traceEvents": [{"ph": "Q", "pid": 1, "tid": 0, "name": "x",
                             "ts": 1.0}]},
           {"traceEvents": [dict(e, ts=-1.0) if e["ph"] != "M" else e
                            for e in doc["traceEvents"]]},
           {"traceEvents": list(reversed(doc["traceEvents"]))}]
    for d in bad:
        got = obs.validate_chrome_trace(d)
        assert got and got == r_obs.validate_chrome_trace(d)


# ---------------------------------------------------------------------------
# the engine's narration against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _repetitive(rng, n, period=6):
    base = rng.integers(2, 64, period).astype(np.int32)
    return np.tile(base, -(-n // period))[:n]


def _traffic(case):
    """(prompts, serving kwargs).  ``preempt``: mixed prompts (repetitive,
    random, a shared pair) on a pool of 8 pages; ``share``: three prompts
    opening with one 20-token head (packmates: one defers), a copy of the
    first (it adopts the first's partial last page and copies it) and a
    random one, at batch 4."""
    rng = np.random.default_rng(31)
    if case == "preempt":
        shared = rng.integers(2, 64, 24).astype(np.int32)
        prompts = [_repetitive(rng, 30), rng.integers(2, 64, 33).astype(
            np.int32),
            np.concatenate([shared, rng.integers(2, 64, 9).astype(np.int32)]),
            np.concatenate([shared, rng.integers(2, 64, 5).astype(np.int32)])]
        return prompts, dict(num_pages=8, max_batch=2,
                             prefill_token_budget=24)
    head = rng.integers(2, 64, 20).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(2, 64, n).astype(np.int32)])
               for n in (7, 3)]
    prompts += [prompts[0].copy(), _repetitive(rng, 26),
                np.concatenate([head, rng.integers(2, 64, 5).astype(
                    np.int32)])]
    return prompts, dict(max_batch=4, prefill_token_budget=64)


def _sv(**kw):
    return dict(dict(page_size=8, max_len=160, spec_k=2), **kw)


# request ids are given (each package counts its own otherwise), so the
# two streams name the same requests
def _port(params, prompts, **sv):
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO, serving=ServingConfig(**_sv(**sv))),
                      params, device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=8, eos_id=-1), rid=i)) for i, p in enumerate(prompts)]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def _ref(ref_params, prompts, **sv):
    eng = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(**_sv(**sv))),
                       ref_params)
    rids = [eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=8, eos_id=-1), rid=i)) for i, p in enumerate(prompts)]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def stream(events):
    """The trace as (kind, rid, slot, payload) with timings removed."""
    return [(e.kind, e.rid, e.slot,
             {k: v for k, v in e.payload.items() if k not in TIMING_KEYS})
            for e in events]


@pytest.fixture(scope="module")
def served(weights):
    ref_params, params = weights
    out = {}
    for case in ("preempt", "share"):
        prompts, sv = _traffic(case)
        out[case] = (_ref(ref_params, prompts, **sv),
                     _port(params, prompts, **sv), prompts, sv)
    return out


@pytest.mark.parametrize("case", ["preempt", "share"])
def test_engine_stream_equals_reference(served, case):
    (want, ref), (got, eng), _, _ = served[case]
    assert got == want
    assert stream(eng.trace.events()) == stream(ref.trace.events())
    assert eng.trace.dropped == ref.trace.dropped == 0
    # spans carry their start and a duration
    spans = [e for e in eng.trace.events()
             if e.kind in ("prefill_call", "decode_call")]
    assert spans and all(e.dur > 0 for e in spans)
    if case == "preempt":
        assert eng.metrics["preemptions"] > 0
    else:
        assert eng.metrics["cow_copies"] > 0
        assert eng.metrics["prefix_shared_tokens"] > 0
    assert eng.metrics["spec_calls"] > 0


def test_engine_streams_cover_the_vocabulary(served):
    kinds = set()
    for case in served:
        kinds |= {e.kind for e in served[case][1][1].trace.events()}
    assert KINDS <= kinds, KINDS - kinds


@pytest.mark.parametrize("case", ["preempt", "share"])
def test_engine_registry_equals_reference_and_replay(served, case):
    (_, ref), (_, eng), _, _ = served[case]
    assert set(eng.metrics) == set(ref.metrics) - REF_ONLY | PORT_ONLY
    assert set(eng.registry.histograms) == \
        set(ref.registry.histograms) - REF_ONLY_HISTOGRAMS
    untimed = [k for k in eng.metrics if not k.endswith("_s")
               and k not in {"ttft_sum", "migration_us"} | PORT_ONLY]
    assert {k: eng.metrics[k] for k in untimed} == \
        {k: ref.metrics[k] for k in untimed}
    assert eng.registry.histogram("accept_len").snapshot() == \
        ref.registry.histogram("accept_len").snapshot()
    assert eng.registry.histogram("tpot").n == \
        ref.registry.histogram("tpot").n > 0
    rc = obs.replay_counters(eng.trace.events())
    assert {k: rc[k] for k in REPLAYABLE} == \
        {k: eng.metrics[k] for k in REPLAYABLE}
    assert rc["pages_allocated"] - rc["pages_freed"] == \
        eng.alloc.used_pages == 0


def test_observability_off_silences_trace_not_registry(served, weights):
    _, params = weights
    (_, _), (got, on), prompts, sv = served["preempt"]
    toks, off = _port(params, prompts, observability=False, **sv)
    assert toks == got
    assert len(off.trace) == 0 and off.trace.dropped == 0
    untimed = [k for k in on.metrics if not k.endswith("_s")
               and k not in ("ttft_sum", "migration_us")]
    assert {k: off.metrics[k] for k in untimed} == \
        {k: on.metrics[k] for k in untimed}
    assert off.registry.histogram("accept_len").snapshot() == \
        on.registry.histogram("accept_len").snapshot()


def test_tp2_ranks_narrate_equal_streams():
    prompts, sv = _traffic("preempt")
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=2),
                    iso=PORT_ISO, serving=ServingConfig(**_sv(**sv)))
    ranks = mesh.spawn(serve_rank, 2, args=(
        config, [dict(prompts=prompts, max_new=8)], None, 0, "float32"),
        device="cpu")
    (a,), (b,) = ranks
    assert a["tokens"] == b["tokens"]
    assert stream(a["trace"]) == stream(b["trace"])
    assert a["metrics"]["preemptions"] > 0
    kinds = {e.kind for e in a["trace"]}
    assert {"evict", "spec_rollback", "decision"} <= kinds
    rc = obs.replay_counters(a["trace"])
    assert {k: rc[k] for k in REPLAYABLE} == \
        {k: a["metrics"][k] for k in REPLAYABLE}


def test_torchprof_annotates_closure_calls(weights, tmp_path):
    _, params = weights
    assert not torchprof.recording()
    prompts, sv = _traffic("share")
    torchprof.start(str(tmp_path))
    try:
        assert torchprof.recording()
        with pytest.raises(RuntimeError):
            torchprof.start(str(tmp_path))
        _, eng = _port(params, prompts[:3], **sv)
    finally:
        path = torchprof.stop()
    assert torchprof.stop() is None and not torchprof.recording()
    doc = json.loads(open(path).read())
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "cpu_op"}
    assert any(n.startswith("decode/K=3/S=") for n in names), names
    assert any(n.startswith("prefill/T=") and "x" in n for n in names)
    assert {"engine/schedule", "engine/prefill.launch", "engine/decode.launch",
            "engine/logits.to_host", "engine/sample"} <= names, names
