"""Speculative decoding in the port's ``PagedEngine`` against the JAX
reference engine and the port's own plain engine, fp32 on the CPU (after
tests/test_paged_spec.py).

  * ``spec_k`` 2 and 4 on mixed traffic (a repetitive prompt the bigram
    draft predicts, random prompts, a sharing pair, packed prefill): tokens
    equal to the plain K=1 port engine and to the JAX engine, with equal
    ``spec_calls`` and ``spec_tokens``; one K=1 and one verify closure;
  * forced recompute preemption, and eviction mid-batch in the decode phase
    near a page boundary, where the window falls back to K=1;
  * the draft stays fresh across K=1 fallbacks while a sampling request
    holds the batch at plain decode;
  * ``BigramDraft`` and ``accept_greedy`` equal to the reference's;
  * without a ``pos`` pool to roll back, the KV of rejected verify
    positions is never read: after every step every slot no request holds
    inside its length is filled with NaN, and the tokens stay the same."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving import speculative as r_spec  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving import speculative  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _sv(spec_k=0, budget=16, max_len=160, num_pages=0, max_batch=2,
        prefix_sharing=True):
    return dict(page_size=8, max_batch=max_batch, max_len=max_len,
                prefill_token_budget=budget, num_pages=num_pages,
                prefix_sharing=prefix_sharing, spec_k=spec_k)


def _dead_slots(eng):
    """(N+1, ps) bool: the slots no request holds inside its length."""
    live = torch.zeros(eng.kv.k[0].shape[1:3], dtype=torch.bool)
    for rid, table in eng.alloc.tables.items():
        n = eng.alloc.lengths.get(rid, 0)
        for j, pg in enumerate(table):
            live[pg, :max(0, min(eng.ps, n - j * eng.ps))] = True
    return ~live


def _port(params, requests, poison=False, **sv):
    """Serve ``requests`` [(prompt, SamplingParams kwargs), ...] on a port
    engine, checking the allocator after every step.  With ``poison`` every
    dead slot is filled with NaN after every step; returns (tokens, engine,
    slots poisoned inside live requests' tables after a verify step: the
    rejected window positions among them)."""
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO, serving=ServingConfig(**_sv(**sv))),
                      params, device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(),
                                    sampling=SamplingParams(**kw)))
            for p, kw in requests]
    past = 0
    for _ in range(10_000):
        calls = eng.metrics["spec_calls"]
        eng.step()
        eng.alloc.check()
        if poison:
            dead = _dead_slots(eng)
            if eng.metrics["spec_calls"] > calls:
                held = {pg for t in eng.alloc.tables.values() for pg in t}
                past += int(dead[sorted(held)].sum()) if held else 0
            for pool in eng.kv.k + eng.kv.v:
                pool[:, dead] = float("nan")
        if not eng.scheduler.waiting and all(s is None for s in eng.slots):
            break
    outs = {st.request.rid: st.generated for st in eng._finished}
    return [outs[r] for r in rids], eng, past


def _ref(ref_params, requests, **sv):
    eng = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(**_sv(**sv))),
                       ref_params)
    rids = [eng.add_request(RRequest(prompt=p.copy(),
                                     sampling=RSampling(**kw)))
            for p, kw in requests]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def _check(weights, requests, spec_k, **sv):
    """Spec tokens (poisoned and not) equal the plain K=1 port engine's and
    the JAX spec engine's; the counters equal the JAX engine's."""
    ref_params, params = weights
    want, ref = _ref(ref_params, requests, spec_k=spec_k, **sv)
    plain, _, _ = _port(params, requests, **sv)
    got, eng, _ = _port(params, requests, spec_k=spec_k, **sv)
    poisoned, p_eng, past = _port(params, requests, poison=True,
                                  spec_k=spec_k, **sv)
    assert got == want == plain == poisoned
    for k in ("spec_calls", "spec_tokens", "decode_calls", "decode_tokens",
              "preemptions", "prefix_shared_tokens", "cow_copies",
              "prefill_calls", "peak_used_pages"):
        assert eng.metrics[k] == ref.metrics[k] == p_eng.metrics[k], k
    assert eng.accepted_per_call() == ref.accepted_per_call()
    assert eng.alloc.free_pages == eng.alloc.num_pages
    return eng, past


def _repetitive(rng, n, period=6):
    base = rng.integers(2, 64, period).astype(np.int32)
    return np.tile(base, -(-n // period))[:n]


def _greedy(new):
    return dict(max_new_tokens=new, eos_id=-1)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_equals_plain_and_reference_on_mixed_traffic(weights, spec_k):
    rng = np.random.default_rng(11)
    shared = rng.integers(2, 64, 24).astype(np.int32)
    prompts = [_repetitive(rng, 30), rng.integers(2, 64, 33).astype(np.int32),
               np.concatenate([shared, rng.integers(2, 64, 9)
                               .astype(np.int32)]),
               np.concatenate([shared, rng.integers(2, 64, 5)
                               .astype(np.int32)])]
    eng, past = _check(weights, [(p, _greedy(8)) for p in prompts], spec_k)
    assert eng.metrics["spec_calls"] > 0 and eng.accepted_per_call() > 1.0
    assert eng.metrics["prefix_shared_tokens"] > 0
    assert set(eng._decode_fns) <= {(1, 1), (spec_k + 1, 1)}
    assert past > 0                          # rejected positions poisoned


def test_spec_with_forced_preemption(weights):
    rng = np.random.default_rng(12)
    prompts = [_repetitive(rng, 40, period=5), _repetitive(rng, 40, period=7)]
    eng, _ = _check(weights, [(p, _greedy(8)) for p in prompts], 2,
                    budget=64, max_len=64, num_pages=8)
    assert eng.metrics["preemptions"] > 0 and eng.metrics["spec_calls"] > 0


def test_spec_decode_phase_eviction_mid_batch(weights):
    """Both requests cross a page boundary with no page free: the window
    falls back to K=1 and the youngest is evicted mid-decode."""
    rng = np.random.default_rng(16)
    base = rng.integers(2, 64, 5).astype(np.int32)
    prompts = [np.tile(base, 4), np.tile(base, 4)]
    eng, _ = _check(weights, [(p, _greedy(8)) for p in prompts], 2,
                    budget=64, max_len=64, num_pages=6, prefix_sharing=False)
    assert eng.metrics["preemptions"] > 0


def test_spec_draft_stays_fresh_across_fallback(weights):
    """While a sampling request decodes, the batch runs plain K=1 steps; the
    greedy request's draft keeps observing, so speculation re-engages on a
    fresh anchor once the sampling request is done."""
    rng = np.random.default_rng(17)
    requests = [(_repetitive(rng, 30), _greedy(20)),
                (rng.integers(2, 64, 12).astype(np.int32),
                 dict(max_new_tokens=4, eos_id=-1, temperature=0.8, seed=7))]
    eng, _ = _check(weights, requests, 2)
    assert eng.metrics["spec_calls"] > 0 and eng.accepted_per_call() > 1.0


def test_draft_and_accept_equal_reference():
    rng = np.random.default_rng(18)
    stream = [int(t) for t in rng.integers(2, 9, 40)]
    drafts = [speculative.BigramDraft(), r_spec.BigramDraft()]
    for d in drafts:
        d.observe(stream[:25])
    for t in stream[25:]:
        assert drafts[0].draft(4) == drafts[1].draft(4)
        for d in drafts:
            d.observe([t])
    assert drafts[0].table == drafts[1].table
    for draft in ([3, 4, 5], [3, 9, 5], [7, 7, 7]):
        for argmaxes in ([3, 4, 5, 6], [3, 4, 1, 6], [1, 2, 3, 4]):
            a = np.asarray(argmaxes)
            assert speculative.accept_greedy(draft, a) == \
                r_spec.accept_greedy(draft, a)
