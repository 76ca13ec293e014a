"""The phase spans of ``PagedEngine.step`` (``obs.torchprof.Span``,
``paged_engine.STEP_SPANS``), fp32 on the CPU at a tiny dense size:

  * over mixed runs (packed prefill, batch-1 prefill, resumed grants,
    decode with and without the speculative window, recompute preemption)
    the span counters tile the step: prep_s + capture_s + prefill_s +
    decode_s + logits_copy_s + sample_s is at most step_s and at least
    90 % of it, and grant_wait_n counts each request once, and once more
    for each preemption;
  * under a plain ``torch.profiler.profile`` (not ``torchprof.start``) each
    phase's ``engine/…`` range is recorded as a host op (no user
    annotation, which would get a device-side copy), ``engine/decode.launch``
    once a decode call, no two ``engine/`` ranges overlap, and each
    closure-call range lies inside a launch range;
  * with no profile recording a span enters no ``torch.profiler`` code;
  * a request queued behind a full prefill budget adds at least the wall
    time of the step it waited through to ``grant_wait_s``;
  * an afmoe engine's MoE counters count: ``moe_calls`` and ``moe_rows``
    (each call's rows, pads included, through each MoE layer) on the
    host, ``moe_experts_hit`` summed on the device and read by
    ``read_moe_hits`` alone; its eager path marks ``moe/route``,
    ``moe/experts`` and ``moe/combine`` as host ranges under a profile."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from conftest import tiny_dense
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig
from repro_torch.models import api
from repro_torch.obs import torchprof
from repro_torch.serving import PagedEngine, Request
from repro_torch.serving.paged_engine import STEP_SPANS
from repro_torch.serving.requests import SamplingParams

torch.set_num_threads(1)

CFG = ModelConfig(**{f: getattr(tiny_dense(vocab_size=64), f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8, chunk_align=8)
PARTS = ("prep_s", "prefill_s", "decode_s", "logits_copy_s", "sample_s")
# mixed traffic: (prompt lengths, serving settings)
CASES = {
    "packed": ((40, 25, 70, 9, 33), dict(max_batch=4,
                                         prefill_token_budget=32)),
    "batch1": ((40, 25, 70, 9, 33), dict(max_batch=4,
                                         prefill_token_budget=32,
                                         prefill_batching=False)),
    "preempt": ((30, 33, 29, 41), dict(max_batch=2, num_pages=8,
                                       prefill_token_budget=24)),
}


@pytest.fixture(scope="module")
def params():
    return api.init_params(0, CFG, dtype=torch.float32, device="cpu")


def _engine(params, **sv):
    sv = dict(dict(page_size=8, max_len=160, spec_k=2), **sv)
    return PagedEngine(Config(model=CFG,
                              parallel=ParallelConfig(data=1, model=1),
                              iso=ISO, serving=ServingConfig(**sv)),
                       params, device="cpu")


def _submit(eng, lengths, new=8, seed=3):
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        # a repeated pattern, so the self-draft hits and windows verify
        base = rng.integers(2, 64, 5).astype(np.int32)
        eng.add_request(Request(prompt=np.resize(base, n), rid=i,
                                sampling=SamplingParams(max_new_tokens=new,
                                                        eos_id=-1)))


def _serve(params, case):
    lengths, sv = CASES[case]
    eng = _engine(params, **sv)
    _submit(eng, lengths)
    out = eng.run_until_complete()
    assert len(out) == len(lengths)
    return eng


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counters_tile_the_step(params, case):
    eng = _serve(params, case)
    m = eng.metrics
    assert m["decode_calls"] > 0 and m["prefill_calls"] > 0
    assert m["spec_calls"] > 0 and m["resumed_grants"] > 0
    if case == "preempt":
        assert m["preemptions"] > 0
    if case == "packed":
        assert m["prefill_calls"] < m["prefill_grants"]
    for k in PARTS:
        assert m[k] > 0, k
    assert eng.capture_s == 0.0               # the CPU captures no graph
    assert m["prefill_s"] >= m["prefill_dispatch_s"] > 0
    assert m["decode_s"] >= m["decode_dispatch_s"] > 0
    parts = eng.capture_s + sum(m[k] for k in PARTS)
    assert 0.9 * m["step_s"] <= parts <= m["step_s"], (parts, m["step_s"])
    n_req = len(CASES[case][0])
    assert m["grant_wait_n"] == n_req + m["preemptions"]
    assert m["grant_wait_s"] > 0


def test_plain_profiler_records_disjoint_engine_ranges(params):
    lengths, sv = CASES["packed"]
    eng = _engine(params, **sv)
    _submit(eng, lengths)
    assert not torchprof.recording()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torchprof.recording()
        eng.run_until_complete()
    assert not torchprof.recording()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events())
    engine = [r for r in ranges if r[2].startswith("engine/")]
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name.startswith(("engine/", "prefill/", "decode/")))
    names = [r[2] for r in engine]
    assert {f"engine/{n}" for n, _ in STEP_SPANS} - set(names) == \
        {"engine/capture"}
    assert names.count("engine/decode.launch") == \
        eng.metrics["decode_calls"]
    assert names.count("engine/prefill.launch") == \
        eng.metrics["prefill_calls"]
    for (_, end, a), (start, _, b) in zip(engine, engine[1:]):
        assert end <= start, (a, b)
    launches = [r for r in engine if r[2].endswith(".launch")]
    calls = [r for r in ranges if r[2].startswith(("prefill/T=",
                                                    "decode/K="))]
    assert len(calls) == len(launches)
    for (a0, a1, call), (b0, b1, launch) in zip(calls, launches):
        assert b0 <= a0 <= a1 <= b1, (call, launch)
        assert call.split("/")[0] == launch[len("engine/"):].split(".")[0]


def test_span_enters_no_profiler_code_when_none_records(params,
                                                       monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a profiler range opened with no profile")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torchprof.annotate("x") as sp:
        pass
    assert sp.dt >= 0
    eng = _serve(params, "packed")
    assert eng.metrics["step_s"] > 0


def test_queued_request_waits_a_step(params):
    eng = _engine(params, max_batch=2, prefill_token_budget=16)
    _submit(eng, (48, 10))
    assert eng.metrics["grant_wait_n"] == 0
    t = time.perf_counter()
    eng.step()
    first = time.perf_counter() - t
    # the first request's grant took the whole budget (an ISO chunk)
    assert eng._by_rid[0].prefilled > 0 and eng._by_rid[1].prefilled == 0
    assert eng.metrics["grant_wait_n"] == 1
    w0 = eng.metrics["grant_wait_s"]
    eng.run_until_complete()
    assert eng.metrics["grant_wait_n"] == 2
    assert eng.metrics["grant_wait_s"] - w0 >= first


def test_moe_counters_count():
    from repro_torch.config import AfmoeModelConfig, SigmoidMoEConfig, \
        afmoe_pattern
    cfg = AfmoeModelConfig(
        name="t-afmoe", family="afmoe", num_layers=4, d_model=32,
        num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
        qk_norm=True, sliding_window=8,
        block_pattern=afmoe_pattern((False, False, False, True), 1),
        moe=SigmoidMoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                             shared_expert_d_ff=16, route_scale=2.0))
    params = api.init_params(1, cfg, dtype=torch.float32, device="cpu")
    eng = PagedEngine(Config(model=cfg,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=ISO, serving=ServingConfig(
                                 page_size=8, max_len=96, max_batch=3,
                                 prefill_token_budget=32)),
                      params, device="cpu")
    rows = {"prefill": 0, "decode": 0}
    stage = {"prefill": eng._call_prefill}

    def prefill(fn, host, label, group):
        rows["prefill"] += np.size(host["tokens"])
        return stage["prefill"](fn, host, label, group)

    eng._call_prefill = prefill
    for i, n in enumerate((30, 12, 41)):
        eng.add_request(Request(prompt=np.arange(2, 2 + n, dtype=np.int32)
                                % 60 + 2, rid=i,
                                sampling=SamplingParams(max_new_tokens=6,
                                                        eos_id=-1)))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_until_complete()
    m = eng.metrics
    calls = m["prefill_calls"] + m["decode_calls"]
    decode_rows = m["decode_calls"] * eng.max_batch        # K = 1
    assert m["moe_calls"] == 3 * calls                     # 3 MoE layers
    assert m["moe_rows"] == 3 * (rows["prefill"] + decode_rows)
    assert m["moe_experts_hit"] == 0                       # not read yet
    hit = eng.read_moe_hits()
    assert m["moe_experts_hit"] == hit
    assert 3 * calls <= hit <= 3 * calls * 4      # 1 to 4 experts a call
    # a range a MoE layer a chunk: ISO splits the longer grants in two
    names = [e.name for e in prof.events()]
    counts = {r: names.count(r) for r in ("moe/route", "moe/experts",
                                          "moe/combine")}
    assert len(set(counts.values())) == 1, counts
    assert m["moe_calls"] < counts["moe/route"] <= 2 * m["moe_calls"]
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name.startswith("moe/"))
