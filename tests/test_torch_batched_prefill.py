"""Batched prefill packs in the port's ``PagedEngine`` against the JAX
reference engine, fp32 on the CPU at the ``tiny_dense`` size (after
tests/test_batched_prefill.py).

Every case serves the reference's own traffic on bridged weights through
both engines and checks the greedy tokens EQUAL, and the pack accounting
(``prefill_calls``, ``prefill_pad_rows``, ``prefill_pad_tokens``), the
sharing and eviction counters equal too; the allocator's invariants
(``PageAllocator.check``: refcounts equal table references, free + live ==
pool, tokens within capacity) hold after every step of either engine.
``pack_grants`` makes the reference's packs on the same grant lists."""
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
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402
from repro.serving.scheduler import \
    TokenBudgetScheduler as RScheduler  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402
from repro_torch.serving.scheduler import TokenBudgetScheduler  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
# the counters each case holds equal to the reference's
COUNTERS = ("prefill_calls", "prefill_grants", "resumed_grants",
            "prefill_pad_rows", "prefill_pad_tokens", "prefix_shared_tokens",
            "cow_copies", "preemptions", "spec_calls", "spec_tokens",
            "decode_calls", "peak_used_pages")


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _serving(batched, budget=256, max_batch=8, max_len=160, num_pages=0,
             prefix_sharing=True, spec_k=0, policy="fcfs"):
    return dict(page_size=8, max_batch=max_batch, max_len=max_len,
                prefill_token_budget=budget, num_pages=num_pages,
                prefix_sharing=prefix_sharing, prefill_batching=batched,
                scheduler_policy=policy, spec_k=spec_k)


def _drain_checked(eng):
    """run_until_complete checking the allocator's invariants every step."""
    for _ in range(10_000):
        eng.step()
        eng.alloc.check()
        if not eng.scheduler.waiting and all(s is None for s in eng.slots):
            break
    return {st.request.rid: st.generated for st in eng._finished}


def _serve(eng, prompts, new, priorities, request, sampling):
    rids = [eng.add_request(request(
        prompt=p.copy(), sampling=sampling(max_new_tokens=new, eos_id=-1),
        priority=0 if priorities is None else priorities[i]))
        for i, p in enumerate(prompts)]
    outs = _drain_checked(eng)
    return [outs[r] for r in rids]


def _port(params, prompts, new=6, priorities=None, **sv):
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO,
                             serving=ServingConfig(**_serving(**sv))),
                      params, device="cpu")
    return _serve(eng, prompts, new, priorities, Request, SamplingParams), eng


def _both(weights, prompts, new=6, priorities=None, **sv):
    """The port's tokens and engine, checked equal to the reference's."""
    ref_params, params = weights
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO,
                               serving=RServing(**_serving(**sv))),
                       ref_params)
    want = _serve(ref, prompts, new, priorities, RRequest, RSampling)
    got, eng = _port(params, prompts, new, priorities, **sv)
    assert got == want
    for k in COUNTERS:
        assert eng.metrics[k] == ref.metrics[k], (k, eng.metrics[k],
                                                  ref.metrics[k])
    assert set(eng._prefill_fns) == set(ref._prefill_fns)
    assert eng.max_prefill_compiles() == ref.max_prefill_compiles()
    assert eng.alloc.free_pages == eng.alloc.num_pages
    return got, eng


def _rand(rng, n):
    return rng.integers(2, 64, n).astype(np.int32)


def test_packed_equals_batch1_four_requests(weights):
    rng = np.random.default_rng(30)
    prompts = [_rand(rng, 32) for _ in range(4)]
    got, e2 = _both(weights, prompts, batched=True, max_batch=4,
                    prefix_sharing=False)
    ref, e1 = _port(weights[1], prompts, batched=False, max_batch=4,
                    prefix_sharing=False)
    assert got == ref
    assert e1.metrics["prefill_grants"] == e2.metrics["prefill_grants"]
    assert e2.metrics["prefill_calls"] * 2 <= e1.metrics["prefill_calls"]
    assert e2.prefill_compile_count() <= e2.max_prefill_compiles()


def test_packed_boundary_lengths_with_sharing(weights):
    """Lengths straddling bucket edges, a sharing pair, and a prompt long
    enough to resume under the budget: fresh rows beside resumed ones."""
    rng = np.random.default_rng(31)
    shared = _rand(rng, 24)
    prompts = [_rand(rng, 15), _rand(rng, 16), _rand(rng, 17),
               _rand(rng, 31), _rand(rng, 33),
               np.concatenate([shared, _rand(rng, 9)]),
               np.concatenate([shared, _rand(rng, 5)]),
               _rand(rng, 70)]
    got, e2 = _both(weights, prompts, batched=True, budget=48)
    ref, e1 = _port(weights[1], prompts, batched=False, budget=48)
    assert got == ref
    m = e2.metrics
    assert m["prefill_calls"] < e1.metrics["prefill_calls"]
    assert m["resumed_grants"] > 0 and m["prefix_shared_tokens"] > 0
    assert m["prefill_calls"] < m["prefill_grants"]
    assert any(not fresh for _, _, fresh in e2._prefill_fns)


def test_packed_with_forced_preemption(weights):
    rng = np.random.default_rng(32)
    prompts = [_rand(rng, 40) for _ in range(3)]
    tight, e_tight = _both(weights, prompts, batched=True, max_len=64,
                           budget=64, num_pages=12, prefix_sharing=False)
    roomy, e_roomy = _port(weights[1], prompts, batched=False, max_len=64,
                           budget=64, prefix_sharing=False)
    assert e_tight.metrics["preemptions"] > 0
    assert e_roomy.metrics["preemptions"] == 0
    assert tight == roomy


def test_packed_with_speculation(weights):
    rng = np.random.default_rng(33)
    base = _rand(rng, 6)
    prompts = [np.tile(base, 5)[:n] for n in (30, 30, 24, 17)]
    got, e2 = _both(weights, prompts, new=10, batched=True, spec_k=2)
    ref, e1 = _port(weights[1], prompts, new=10, batched=False)
    assert got == ref
    assert e2.metrics["spec_calls"] > 0 and e2.accepted_per_call() > 1.0
    assert e2.metrics["prefill_calls"] < e1.metrics["prefill_calls"]


def test_row_bucketing_pads_odd_packs(weights):
    """A 3-grant pack pads to 4 rows; the pad row writes only to the
    scratch page, and every page, the scratch page included, holds finite
    values afterwards."""
    rng = np.random.default_rng(34)
    prompts = [_rand(rng, 16) for _ in range(3)]
    _, eng = _both(weights, prompts, batched=True, max_batch=4,
                   prefix_sharing=False)
    assert eng.metrics["prefill_pad_rows"] > 0
    assert (16, 4, True) in eng._prefill_fns
    assert all(len(k) == 3 for k in eng._prefill_fns)
    for pool in eng.kv.k + eng.kv.v:
        assert torch.isfinite(pool).all()


def test_same_pack_fresh_sharers_deferred_and_still_share(weights):
    rng = np.random.default_rng(36)
    prompt = _rand(rng, 32)
    prompts = [prompt, prompt.copy(), prompt.copy()]
    got, e2 = _both(weights, prompts, batched=True, max_batch=4)
    ref, e1 = _port(weights[1], prompts, batched=False, max_batch=4)
    assert got == ref
    assert e1.metrics["prefix_shared_tokens"] > 0
    assert e2.metrics["prefix_shared_tokens"] == \
        e1.metrics["prefix_shared_tokens"]


def test_packed_priority_policy(weights):
    rng = np.random.default_rng(35)
    prompts = [_rand(rng, n) for n in (16, 16, 32, 32)]
    prios = [0, 5, 5, 0]
    got, _ = _both(weights, prompts, priorities=prios, batched=True,
                   policy="priority", max_batch=4, prefix_sharing=False)
    ref, _ = _port(weights[1], prompts, priorities=prios, batched=False,
                   policy="priority", max_batch=4, prefix_sharing=False)
    assert got == ref


# (policy, (rid, priority) arrivals, prefill states, max_rows, buckets)
PACKS = [
    ("fcfs", ((1, 0), (2, 0), (3, 0), (4, 0)),
     [(1, 0, (16,)), (2, 0, (8,)), (3, 0, (16,)), (4, 0, (8,))], 4,
     (8, 16, 32, 64)),
    ("priority", ((1, 0), (2, 5), (3, 0), (4, 5)),
     [(1, 0, (16,)), (2, 0, (16,)), (3, 0, (8,)), (4, 0, (16,))], 4,
     (8, 16, 32, 64)),
    ("fcfs", tuple((r, 0) for r in range(5)),
     [(r, 0, (16,)) for r in range(5)], 2, (16,)),
    ("fcfs", tuple((r, 0) for r in range(5)),
     [(r, 0, (16,)) for r in range(5)], 1, (16,)),
]


@pytest.mark.parametrize("policy,arrivals,states,max_rows,buckets", PACKS,
                         ids=["fcfs", "priority", "max_rows", "singletons"])
def test_pack_grants_equal_reference(policy, arrivals, states, max_rows,
                                     buckets):
    """The same packs as the reference's scheduler, whatever the order of
    the prefill states."""
    scheds = [cls(policy, prefill_token_budget=256 if max_rows < 4 else 64,
                  grant_buckets=buckets)
              for cls in (TokenBudgetScheduler, RScheduler)]
    for sched in scheds:
        for rid, prio in arrivals:
            sched.add(rid, priority=prio)
    for perm in (states, states[::-1]):
        packs = [[[(g.rid, g.start, g.n_tokens, g.padded, g.last) for g in p]
                  for p in s.pack_grants(s.grant_prefill(perm),
                                         max_rows=max_rows)]
                 for s in scheds]
        assert packs[0] == packs[1]
        assert sum(len(p) for p in packs[0]) == len(states)
