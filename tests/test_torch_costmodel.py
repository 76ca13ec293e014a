"""The port's measured cost model (``repro_torch.perf.costmodel``) against
the reference's ``repro.perf.costmodel`` and JAX engine, fp32 on the CPU at
the ``tiny_dense`` size.

  * ``fit_linear``, ``_interp``, ``validate_table`` and every ``CostModel``
    decision (``decode_splits``, ``grant_cap``, ``pack_rows``,
    ``spec_worth``, and the ``collective_s`` / ``decode_us`` /
    ``prefill_us`` lookups) equal the reference's on the reference tests'
    hand-built tables and on hypothesis-drawn ones: the port keeps the
    reference's float operations in their order;
  * each of ``load_cost_model``'s failure paths (missing, unreadable,
    invalid, another platform, another tp) emits exactly one ``warning``,
    the reference's, and the engine then serves on the static defaults;
  * the forcing table of tests/test_costmodel.py's differential, on its
    mixed prompts with sharing, spec_k=2 and a pool of 8 pages (where the
    reference preempts): port modeled tokens == port static tokens == JAX
    modeled tokens, both packages preempt, the decision sequences
    (point, chosen, static) and the closure keys equal the JAX engine's,
    and a modeled S > 1 decodes;
  * the spec gate closes on a table where verify costs more than the
    accepts it replaces, as in the reference, and token-neutrally;
  * ``autotune(smoke=True, device="cpu")`` yields a valid table the engine
    loads from a path with no warning;
  * the bundled ``perf/tables/h100_tp1.json`` validates and loads, and a
    CPU engine with ``cost_table="auto"`` warns ``missing`` once (no CPU
    table is bundled);
  * ``device.platform_name`` maps card names to the profiles' keys."""
import json
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.perf import costmodel as r_cm  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge, device as dev_mod  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.perf import costmodel as cm  # noqa: E402
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


def _table(*, platform="cpu", tp=1, prefill=None, decode=None,
           alpha=1e-6, beta=1e-10):
    """tests/test_costmodel.py's hand-built schema-valid table."""
    return {
        "schema": cm.SCHEMA, "version": 1, "platform": platform,
        "mesh": {"tp": tp}, "model": "t-dense", "page_size": 8,
        "alpha_beta": {"alpha_s": alpha, "beta_s_per_byte": beta, "r2": 1.0},
        "prefill_us": prefill if prefill is not None
        else {"16x1": 100.0, "32x1": 150.0, "64x1": 260.0},
        "decode_us": decode if decode is not None
        else {"1/1/2": 50.0, "1/1/8": 90.0},
    }


# the forcing table of the reference's model-vs-static differential
FORCING = _table(
    prefill={"16x1": 100.0, "16x2": 150.0, "32x1": 400.0,
             "32x2": 500.0, "64x1": 900.0, "64x2": 1100.0},
    decode={"1/1/2": 100.0, "1/2/2": 40.0, "3/1/2": 5000.0,
            "3/2/2": 5000.0, "1/1/16": 400.0, "1/2/16": 150.0,
            "3/1/16": 5000.0, "3/2/16": 5000.0})

# the reference tests' hand-built tables
HAND = [
    _table(),
    FORCING,
    _table(decode={"1/1/4": 100.0, "1/2/4": 60.0, "1/4/4": 80.0,
                   "1/1/16": 400.0, "1/2/16": 390.0, "1/4/16": 200.0}),
    _table(decode={"1/1/8": 100.0, "1/2/8": 100.0, "1/4/8": 50.0}),
    _table(prefill={"16x1": 100.0, "32x1": 120.0, "64x1": 400.0}),
    _table(prefill={"32x1": 100.0, "32x2": 150.0, "32x4": 500.0}),
    _table(decode={"1/1/8": 100.0, "3/1/8": 150.0}),
    _table(decode={"1/1/2": 100.0, "1/1/16": 100.0, "3/1/2": 1000.0,
                   "3/1/16": 1000.0}),
    _table(prefill={f"{t}x{r}": 100.0 * t * (r ** 2) / 16
                    for t in (16, 32, 64) for r in (1, 2, 4)}),
    _table(prefill={f"{t}x{r}": 50.0 * t / 16 + 10.0 * r
                    for t in (16, 32) for r in (1, 2)},
           decode={"1/1/2": 100.0, "1/2/2": 60.0, "3/1/2": 140.0,
                   "1/1/16": 300.0, "1/2/16": 150.0, "3/1/16": 350.0}),
    _table(alpha=2e-6, beta=1e-9),
]


def _decisions(doc):
    """Every decision and lookup of a CostModel over a grid of inputs, as
    a list (reference and port side by side)."""
    port, ref = cm.CostModel(doc), r_cm.CostModel(doc)
    out = []
    for m in (port, ref):
        row = [m.platform, m.tp, m.alpha_s, m.beta_s_per_byte,
               m.matches("cpu", 1), m.matches("h100", 1)]
        for nbytes in (0, 1000, 1 << 20):
            row.append(m.collective_s(nbytes))
        for depth in (0, 1, 2, 3, 5, 8, 13, 16, 40, 200):
            for K in (1, 3, 5):
                row.append(m.decode_us(K, 1, depth))
                row.append(m.decode_us(K, 2, depth))
                for cap in (0, 1, 2, 4, 64):
                    row.append(m.decode_splits(depth, K, max_splits=cap))
                for ea in (0.5, 1.0, 1.7, 3.0, 9.0):
                    row.append(m.spec_worth(K, depth, ea))
        for buckets in (None, (16,), (16, 64), (32, 128), (128,)):
            row.append(m.grant_cap(buckets))
        for padded in (1, 7, 16, 24, 32, 40, 64, 100, 1000):
            row.append(m.pack_rows(padded))
        for bucket in (16, 32, 64, 128):
            for rows in (1, 2, 4):
                row.append(m.prefill_us(bucket, rows))
        out.append(row)
    return out


@pytest.mark.parametrize("i", range(len(HAND)))
def test_decisions_equal_reference_on_hand_tables(i):
    port, ref = _decisions(HAND[i])
    assert port == ref


_times = st.floats(min_value=0.5, max_value=1e6, allow_nan=False,
                   allow_infinity=False)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(
    st.tuples(st.sampled_from((1, 3, 5)), st.sampled_from((1, 2, 4, 8)),
              st.integers(min_value=1, max_value=64)), _times,
    min_size=1, max_size=24),
    st.dictionaries(
        st.tuples(st.sampled_from((16, 32, 64, 128, 1024)),
                  st.sampled_from((1, 2, 4))), _times, min_size=1,
        max_size=12),
    st.floats(min_value=0, max_value=1e-3),
    st.floats(min_value=0, max_value=1e-8))
def test_decisions_equal_reference_on_drawn_tables(decode, prefill, alpha,
                                                   beta):
    doc = _table(decode={f"{k}/{s}/{d}": t for (k, s, d), t in
                         decode.items()},
                 prefill={f"{t}x{r}": v for (t, r), v in prefill.items()},
                 alpha=alpha, beta=beta)
    assert cm.validate_table(doc) == r_cm.validate_table(doc) == []
    port, ref = _decisions(doc)
    assert port == ref


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.floats(min_value=0, max_value=1e7),
                          st.floats(min_value=0, max_value=10)),
                min_size=1, max_size=8),
       st.lists(st.tuples(st.integers(min_value=1, max_value=64), _times),
                min_size=1, max_size=6, unique_by=lambda p: p[0]),
       st.integers(min_value=0, max_value=200))
def test_fit_and_interp_equal_reference(samples, points, x):
    assert cm.fit_linear(samples) == r_cm.fit_linear(samples)
    pts = sorted(points)
    assert cm._interp(pts, x) == r_cm._interp(pts, x)


def test_fit_linear_recovers_a_line_and_clamps():
    alpha, beta = 3e-6, 2e-10
    xs = [1024, 8192, 65536, 1 << 20]
    a, b, r2 = cm.fit_linear([(x, alpha + beta * x) for x in xs])
    assert abs(a - alpha) < 1e-9 and abs(b - beta) / beta < 1e-6
    assert r2 > 0.999
    assert cm.fit_linear([(100.0, 5.0)]) == (5.0, 0.0, 1.0)
    assert cm.fit_linear([(10.0, 0.1), (20.0, 30.0)])[0] >= 0.0


def _bad_tables():
    out = [[], {"schema": "costmodel-v1"}]
    for mutate in (lambda d: d.update(schema="nope"),
                   lambda d: d["alpha_beta"].update(alpha_s=float("nan")),
                   lambda d: d["alpha_beta"].update(beta_s_per_byte=-1.0),
                   lambda d: d.update(decode_us={"1/1": 50.0}),
                   lambda d: d.update(prefill_us={"16x1": -1.0}),
                   lambda d: d.update(prefill_us={"16xa": 1.0}),
                   lambda d: d.pop("mesh"), lambda d: d.update(version=0),
                   lambda d: d.update(platform="")):
        d = _table()
        mutate(d)
        out.append(d)
    return out


def test_validate_table_equals_reference():
    assert cm.validate_table(_table()) == []
    for doc in _bad_tables():
        got = cm.validate_table(doc)
        assert got and got == r_cm.validate_table(doc)
        if isinstance(doc, dict) and doc.get("schema") == cm.SCHEMA \
                and "mesh" in doc:
            with pytest.raises(ValueError):
                cm.CostModel(doc)
    # keys outside the schema are ignored
    assert cm.validate_table(dict(_table(), device="x", power_limit="1 W",
                                  engine={"max_batch": 4})) == []


def test_measure_alpha_beta_local_on_the_cpu():
    ab = cm.measure_alpha_beta(sizes=(1024, 65536), iters=2, warmup=1)
    assert ab["collective"] == "local" and len(ab["samples"]) == 2
    assert math.isfinite(ab["alpha_s"]) and ab["alpha_s"] >= 0
    assert math.isfinite(ab["beta_s_per_byte"]) and ab["beta_s_per_byte"] >= 0


# ---------------------------------------------------------------------------
# loading: one warning a failure, then the static path
# ---------------------------------------------------------------------------

def _warnings(eng):
    return [e.payload for e in eng.trace.events() if e.kind == "warning"]


def _failures(tmp_path):
    paths = {"missing": tmp_path / "nope.json"}
    paths["unreadable"] = tmp_path / "bad.json"
    paths["unreadable"].write_text("{not json")
    paths["invalid"] = tmp_path / "invalid.json"
    paths["invalid"].write_text(json.dumps({"schema": "costmodel-v1"}))
    paths["platform"] = tmp_path / "tpu.json"
    paths["platform"].write_text(json.dumps(_table(platform="tpu")))
    paths["tp"] = tmp_path / "tp8.json"
    paths["tp"].write_text(json.dumps(_table(tp=8)))
    return paths


class _Ring:
    def __init__(self):
        self.events = []

    def emit(self, kind, **kw):
        self.events.append((kind, kw))


def test_load_failures_warn_once_as_the_reference(tmp_path):
    for name, path in _failures(tmp_path).items():
        rings = (_Ring(), _Ring())
        assert cm.load_cost_model(str(path), platform="cpu", tp=1,
                                  trace=rings[0]) is None
        assert r_cm.load_cost_model(str(path), platform="cpu", tp=1,
                                    trace=rings[1]) is None
        assert len(rings[0].events) == 1, name
        assert rings[0].events == rings[1].events, name
        kind, payload = rings[0].events[0]
        assert kind == "warning" and payload["what"] == "cost_table"
        assert payload["path"] == str(path)
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_table()))
    ring = _Ring()
    model = cm.load_cost_model(str(good), platform="cpu", tp=1, trace=ring)
    assert model is not None and model.platform == "cpu" and not ring.events


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _sv(spec_k=2, num_pages=8, max_batch=2, budget=24, **kw):
    return dict(page_size=8, max_batch=max_batch, max_len=160,
                num_pages=num_pages, prefill_token_budget=budget,
                spec_k=spec_k, **kw)


def _port_engine(params, **sv):
    return PagedEngine(Config(model=PORT_CFG,
                              parallel=ParallelConfig(data=1, model=1),
                              iso=PORT_ISO, serving=ServingConfig(**_sv(**sv))),
                       params, device="cpu")


def _run(eng, prompts, request=Request, sampling=SamplingParams, new=8):
    rids = [eng.add_request(request(prompt=p.copy(), sampling=sampling(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids]


def _repetitive(rng, n, period=6):
    base = rng.integers(2, 64, period).astype(np.int32)
    return np.tile(base, -(-n // period))[:n]


def _mixed_prompts(rng):
    """tests/test_costmodel.py's ``_mixed_prompts``."""
    shared = rng.integers(2, 64, 24).astype(np.int32)
    return [
        _repetitive(rng, 30),
        rng.integers(2, 64, 33).astype(np.int32),
        np.concatenate([shared, rng.integers(2, 64, 9).astype(np.int32)]),
        np.concatenate([shared, rng.integers(2, 64, 5).astype(np.int32)]),
    ]


def test_failed_load_serves_as_no_table(weights, tmp_path):
    _, params = weights
    prompts = _mixed_prompts(np.random.default_rng(5))
    plain = _run(_port_engine(params), prompts)
    for name, path in _failures(tmp_path).items():
        eng = _port_engine(params, cost_table=str(path))
        assert eng.cost_model is None and len(_warnings(eng)) == 1, name
        assert _run(eng, prompts) == plain, name
        assert not [e for e in eng.trace.events() if e.kind == "decision"]


# ---------------------------------------------------------------------------
# the model-vs-static differential, the reference as the oracle
# ---------------------------------------------------------------------------

def _decision_seq(eng):
    return [(e.payload["point"], e.payload["chosen"], e.payload["static"])
            for e in eng.trace.events() if e.kind == "decision"]


def test_forcing_table_token_equal_and_decisions_equal_reference(weights):
    ref_params, params = weights
    prompts = _mixed_prompts(np.random.default_rng(31))
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(
                                   **_sv(cost_model=r_cm.CostModel(FORCING)))),
                       ref_params)
    want = _run(ref, prompts, RRequest, RSampling)
    static_eng = _port_engine(params)
    static = _run(static_eng, prompts)
    eng = _port_engine(params, cost_model=cm.CostModel(FORCING))
    modeled = _run(eng, prompts)
    assert modeled == static == want
    assert static_eng.metrics["preemptions"] > 0
    assert eng.metrics["preemptions"] == ref.metrics["preemptions"] > 0
    seq = _decision_seq(eng)
    assert seq == _decision_seq(ref)
    points = {p for p, _, _ in seq}
    assert {"kv_splits", "grant_cap"} <= points
    assert set(eng._decode_fns) == set(ref._decode_fns)
    assert set(eng._prefill_fns) == set(ref._prefill_fns)
    assert any(s > 1 for _, s in eng._decode_fns)
    # without the model the static S stays 1 at these depths
    assert all(s == 1 for _, s in static_eng._decode_fns)


def test_spec_gate_closes_as_the_reference(weights, monkeypatch):
    """Verify costs 10x a plain step: the gate closes once the histogram
    holds a sample, token-neutrally; a table where verify is cheaper than
    one plain step keeps it open."""
    ref_params, params = weights
    monkeypatch.setattr(PagedEngine, "SPEC_GATE_MIN_SAMPLES", 1)
    monkeypatch.setattr(RPagedEngine, "SPEC_GATE_MIN_SAMPLES", 1)
    rng = np.random.default_rng(12)
    prompts = [_repetitive(rng, 30), _repetitive(rng, 24)]
    plain = _run(_port_engine(params, spec_k=0, num_pages=0), prompts,
                 new=10)
    for verify, closes in ((1000.0, True), (90.0, False)):
        table = _table(decode={"1/1/2": 100.0, "1/1/16": 100.0,
                               "3/1/2": verify, "3/1/16": verify})
        eng = _port_engine(params, num_pages=0,
                           cost_model=cm.CostModel(table))
        ref = RPagedEngine(RConfig(
            model=REF_CFG, parallel=RParallel(data=1, model=1), iso=REF_ISO,
            serving=RServing(**_sv(num_pages=0,
                                   cost_model=r_cm.CostModel(table)))),
            ref_params)
        assert _run(eng, prompts, new=10) == plain == \
            _run(ref, prompts, RRequest, RSampling, new=10)
        gate = [d for d in _decision_seq(eng) if d[0] == "spec_gate"]
        assert bool(gate) == closes
        assert all(d == ("spec_gate", 1, 3) for d in gate)
        assert _decision_seq(eng) == _decision_seq(ref)
        assert eng.metrics["spec_calls"] == ref.metrics["spec_calls"] > 0


# ---------------------------------------------------------------------------
# autotune, the bundled table, the platform key
# ---------------------------------------------------------------------------

def test_autotune_smoke_table_loads_from_a_path(weights, tmp_path):
    _, params = weights
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=1),
                    iso=PORT_ISO, serving=ServingConfig(**_sv(spec_k=0,
                                                              num_pages=0)))
    table = cm.autotune(config, params, smoke=True, device="cpu")
    assert cm.validate_table(table) == []
    assert table["platform"] == "cpu" and table["mesh"] == {"tp": 1}
    assert table["alpha_beta"]["collective"] == "local"
    assert table["prefill_us"] and table["decode_us"]
    assert {k.split("/")[0] for k in table["decode_us"]} == {"1", "3"}
    path = cm.write_table(table, str(tmp_path / "t" / "cpu_tp1.json"))
    prompts = _mixed_prompts(np.random.default_rng(41))
    static = _run(_port_engine(params, num_pages=0), prompts)
    eng = _port_engine(params, num_pages=0, cost_table=path)
    assert eng.cost_model is not None and not _warnings(eng)
    assert _run(eng, prompts) == static


def test_bundled_h100_table_validates_and_cpu_auto_warns(weights):
    _, params = weights
    path = cm.default_table_path("h100", 1)
    assert os.path.basename(path) == "h100_tp1.json"
    with open(path) as f:
        doc = json.load(f)
    assert cm.validate_table(doc) == []
    model = cm.CostModel.from_file(path)
    assert model.matches("h100", 1) and not model.matches("cpu", 1)
    assert doc["device"].startswith("NVIDIA H100") and doc["power_limit"]
    assert doc["model"] == "qwen3-8b" and doc["graphed"]
    assert cm.main(["--validate", path]) == 0
    # only the H100 table is bundled: a CPU engine finds none
    assert not os.path.exists(cm.default_table_path("cpu", 1))
    eng = _port_engine(params, cost_table="auto")
    assert eng.cost_model is None
    (w,) = _warnings(eng)
    assert w["reason"] == "missing"
    assert w["path"] == cm.default_table_path("cpu", 1)


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A800-SXM4-80GB", "a800"), ("NVIDIA GeForce RTX 4090", "4090")])
def test_platform_name(monkeypatch, name, want):
    assert dev_mod.platform_name("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert dev_mod.platform_name("cuda:0") == want
