"""The port's dense-cache ``Engine`` (``serving/engine.py``) against the JAX
``Engine``, fp32 on the CPU on bridged ``tiny_dense`` weights, after
tests/test_serving.py and the dense-engine cases of tests/test_obs.py:

  * continuous batching (3 requests on 2 slots; 5 requests, slots reused),
    EOS stopping early and the spec_k = 3 verify window: tokens equal to the
    JAX engine's and to the port's own incremental recomputation, counters
    equal to the JAX engine's key for key;
  * the dense decode at K = 3 equal to three sequential K = 1 steps, and to
    the JAX package's logits (atol 2e-4, the reference's own bound);
  * the trace: the same event stream as the JAX engine once timings are
    removed, replaying into the registry; the replayable key set shared
    with ``PagedEngine``;
  * the VLM family and its requests (ROADMAP queue A item 10) and a mesh
    (item 11) raise, naming their item."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_vlm  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge, obs  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.obs.replay import REPLAYABLE  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f.name: getattr(REF_CFG, f.name)
                          for f in dataclasses.fields(ModelConfig)})
REF_ISO = iso_cfg(2, min_chunk_tokens=16, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=16,
                     chunk_align=8)
TIMING_KEYS = ("dur", "ts")


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _port_engine(params, **kw):
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=1),
                    iso=PORT_ISO)
    return Engine(config, params, device="cpu",
                  **dict(dict(max_batch=2, max_len=128, bucket=16), **kw))


def _serve(eng, request, prompts, max_new, eos=-1):
    # request ids are given, so the two engines' streams name the same
    # requests
    rids = [eng.add_request(request(
        prompt=p.copy(), rid=i, sampling=(RSampling if request is RRequest
                                          else SamplingParams)(
            max_new_tokens=max_new, eos_id=eos)))
        for i, p in enumerate(prompts)]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids]


def _pair(weights, prompts, max_new, eos=-1, **kw):
    """The port's and the JAX engine's tokens, and both engines."""
    ref_params, params = weights
    port = _port_engine(params, **kw)
    ref = REngine(RConfig(model=REF_CFG, parallel=RParallel(data=1, model=1),
                          iso=REF_ISO), ref_params, mesh=None,
                  **dict(dict(max_batch=2, max_len=128, bucket=16), **kw))
    return (_serve(port, Request, prompts, max_new, eos), port,
            _serve(ref, RRequest, prompts, max_new, eos), ref)


def _untimed(eng):
    return {k: eng.metrics[k] for k in eng.metrics
            if not k.endswith("_s") and k != "ttft_sum"}


def _recompute(params, prompt, n_new):
    """Greedy tokens by full recomputation: a fresh prefill over prompt +
    generated each step (the port's own model, no cache)."""
    toks, out = list(prompt), []
    for _ in range(n_new):
        o = api.prefill(params, PORT_CFG, AxisCtx(), ISOConfig(enabled=False),
                        {"tokens": torch.tensor([toks])}, logits_mode="last")
        out.append(int(torch.argmax(
            o["logits_local"][0, -1, :PORT_CFG.vocab_size])))
        toks.append(out[-1])
    return out


def _traffic(case):
    rng = np.random.default_rng(dict(mixed=0, reuse=1, spec=5)[case])
    if case == "mixed":                     # test_serving.py:41
        return [rng.integers(2, 64, n).astype(np.int32)
                for n in (10, 23, 7)], 5, {}
    if case == "reuse":                     # more requests than slots (:53)
        return [rng.integers(2, 64, 8).astype(np.int32)
                for _ in range(5)], 3, {}
    base = rng.integers(2, 64, 6).astype(np.int32)    # repetitive (:96)
    return [np.tile(base, 5), rng.integers(2, 64, 19).astype(np.int32)], \
        10, dict(spec_k=3)


@pytest.mark.parametrize("case", ["mixed", "reuse", "spec"])
def test_engine_equals_reference_and_recomputation(weights, case):
    prompts, max_new, kw = _traffic(case)
    got, eng, want, ref = _pair(weights, prompts, max_new, **kw)
    assert got == want
    assert _untimed(eng) == _untimed(ref)
    assert eng.metrics["completed"] == len(prompts)
    assert all(len(t) == max_new for t in got)
    for p, toks in zip(prompts[:3], got):
        assert toks == _recompute(weights[1], p, max_new)
    if case == "spec":
        # the draft amortised calls: fewer decode calls than tokens
        assert eng.metrics["spec_calls"] > 0
        assert eng.metrics["spec_accepted"] > 0
        plain, _, _, _ = _pair(weights, prompts, max_new)
        assert got == plain


def test_engine_eos_stops_early(weights):
    prompt = np.random.default_rng(0).integers(2, 64, 10).astype(np.int32)
    full = _recompute(weights[1], prompt, 8)
    got, eng, want, ref = _pair(weights, [prompt], 8, eos=full[2])
    assert got == want == [full[:3]]
    assert _untimed(eng) == _untimed(ref)


def test_multi_token_decode_matches_sequential(weights):
    """A K = 3 window over the dense cache equals three K = 1 steps and the
    JAX package's window (test_serving.py:126)."""
    ref_params, params = weights
    rng = np.random.default_rng(9)
    toks = rng.integers(2, 64, (2, 16)).astype(np.int32)
    win = rng.integers(2, 64, (2, 3)).astype(np.int32)
    lengths = np.full((2,), 16, np.int32)

    def port_caches():
        return api.prefill(params, PORT_CFG, AxisCtx(),
                           ISOConfig(enabled=False),
                           {"tokens": torch.from_numpy(toks)},
                           return_cache=True, cache_len=32)["caches"]

    multi, caches = api.decode_step(params, PORT_CFG, AxisCtx(),
                                    torch.from_numpy(win), port_caches(),
                                    torch.from_numpy(lengths))
    seq, c = [], port_caches()
    for j in range(3):
        lg, c = api.decode_step(params, PORT_CFG, AxisCtx(),
                                torch.from_numpy(win[:, j:j + 1]), c,
                                torch.from_numpy(lengths + j))
        seq.append(lg)
    assert float((multi - torch.cat(seq, 1)).abs().max()) < 2e-4
    torch.testing.assert_close(caches[0]["k"], c[0]["k"], atol=2e-4, rtol=0)
    torch.testing.assert_close(caches[0]["v"], c[0]["v"], atol=2e-4, rtol=0)
    assert torch.equal(caches[0]["pos"], c[0]["pos"])
    r_caches = r_api.prefill(ref_params, REF_CFG, RAxisCtx(),
                             iso_cfg(enabled=False),
                             {"tokens": jnp.asarray(toks)},
                             return_cache=True, cache_len=32)["caches"]
    r_multi, r_after = r_api.decode_step(ref_params, REF_CFG, RAxisCtx(),
                                         jnp.asarray(win), r_caches,
                                         jnp.asarray(lengths))
    np.testing.assert_allclose(multi.numpy(), np.asarray(r_multi), atol=2e-4)
    np.testing.assert_array_equal(caches[0]["pos"].numpy(),
                                  np.asarray(r_after[0]["pos"]))


def _stream(events):
    return [(e.kind, e.rid, e.slot,
             {k: v for k, v in e.payload.items() if k not in TIMING_KEYS})
            for e in events]


def test_engine_trace_equals_reference_and_replays(weights):
    """test_obs.py:415 on both engines: the same event stream once timings
    are removed, the port's replaying into its registry, one TTFT a
    request."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 64, n).astype(np.int32) for n in (20, 11, 15)]
    got, eng, want, ref = _pair(weights, prompts, 4, max_len=96)
    assert got == want
    assert _stream(eng.trace.events()) == _stream(ref.trace.events())
    assert eng.trace.dropped == 0
    m = eng.metrics
    assert m["ttft_n"] == 3 and m["ttft_sum"] > 0 and m["preemptions"] == 0
    assert eng.registry.histogram("ttft").n == 3
    rep = obs.replay_counters(eng.trace.events())
    assert {k: rep[k] for k in REPLAYABLE if k in m} == \
        {k: m[k] for k in REPLAYABLE if k in m}
    assert rep["completed"] == 3
    assert m["decode_tokens"] + m["prefill_samples"] == \
        sum(len(t) for t in got)
    assert obs.validate_chrome_trace(obs.chrome_trace(eng.trace.events())) \
        == []
    spans = [e for e in eng.trace.events()
             if e.kind in ("prefill_call", "decode_call")]
    assert spans and all(e.dur > 0 for e in spans)


def test_dense_and_paged_share_replayable_key_set(weights):
    """test_obs.py:440: every counter a dashboard diffs exists in both
    engines' registries; the dense set equals the JAX dense engine's."""
    _, params = weights
    dense = _port_engine(params, max_len=96)
    paged = PagedEngine(Config(model=PORT_CFG,
                               parallel=ParallelConfig(data=1, model=1),
                               iso=PORT_ISO,
                               serving=ServingConfig(max_batch=2, max_len=96,
                                                     page_size=8)),
                        params, device="cpu")
    for name in ("decode_tokens", "prefill_samples", "ttft_sum", "ttft_n",
                 "preemptions", "completed", "prefill_s", "decode_s",
                 "prefill_dispatch_s", "decode_dispatch_s"):
        assert name in paged.metrics and name in dense.metrics, name
    ref = REngine(RConfig(model=REF_CFG, parallel=RParallel(data=1, model=1),
                          iso=REF_ISO), weights[0], mesh=None, max_batch=2,
                  max_len=96, bucket=16)
    assert set(dense.metrics) == set(ref.metrics)
    # the port keeps the one histogram something reads (chip_smoke.py)
    assert set(dense.registry.histograms) == \
        set(ref.registry.histograms) - {"tpot", "accept_len"} == {"ttft"}


def test_outside_the_slice_raises(weights):
    """A mesh must be a ``TPGroup`` (the dense Engine under TP:
    tests/test_torch_runner.py); the VLM family serves
    (tests/test_torch_vlm.py), and a request's patches must have the
    model's width; the cache dtype follows the params."""
    _, params = weights
    vlm = tiny_vlm(vocab_size=64)
    vcfg = ModelConfig(**{f.name: getattr(vlm, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    Engine(Config(model=vcfg), params, device="cpu")
    eng = _port_engine(params)
    assert eng.caches[0]["k"].dtype == torch.float32
    with pytest.raises(ValueError, match="patches of shape"):
        eng.add_request(Request(prompt=np.arange(2, 10, dtype=np.int32),
                                patches=np.zeros((8, 32), np.float32)))
    with pytest.raises(TypeError, match="TPGroup"):
        Engine(Config(model=PORT_CFG), params, mesh=object(), device="cpu")
    half = _port_engine(api.init_params(0, PORT_CFG, dtype=torch.bfloat16,
                                        device="cpu"))
    assert half.caches[0]["k"].dtype == torch.bfloat16
