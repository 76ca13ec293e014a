"""Copy-on-write prefix sharing in the port against the JAX reference, fp32
on the CPU (after tests/test_prefix_sharing.py).

  * the allocator (``adopt``, ``cow``, ``cow`` out of pages mutating
    nothing) and ``PrefixCache.lookup`` (hash hit verified token by token,
    extended into the donor's partial page) fed the same calls as the
    reference's, with the same results and state;
  * engine cases on bridged weights: a shared system prompt gives the
    unshared tokens with fewer pages, identical prompts copy on write, and
    freeing one sharer keeps the other's KV; tokens, ``cow_copies``,
    ``prefix_shared_tokens`` and ``peak_used_pages`` equal the reference's;
  * without a ``pos`` pool, a sharee never reads the donor's tail of a page
    it adopted: after every copy-on-write the copy's slots past the sharee's
    length, and after every step every slot no request holds inside its
    length, are filled with NaN, and the tokens stay the same."""
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
from repro.serving.kvcache import PageAllocator as RAlloc  # noqa: E402
from repro.serving.kvcache import PrefixCache as RPrefixCache  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import OutOfPages, PageAllocator, \
    PrefixCache  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)


# ---------------------------------------------------------------------------
# the allocator and the prefix cache, call for call against the reference's
# ---------------------------------------------------------------------------

def _state(a):
    return (sorted(a._free), {r: list(t) for r, t in a.tables.items()},
            dict(a.lengths), dict(a.refcount), a.stats())


def _both_allocs(num_pages, page_size, calls):
    """Run ``calls`` [(method, args), ...] on the port's and the reference's
    allocator; every result, and the state after each call, equal.  A call
    raising ``OutOfPages`` must raise in both and mutate nothing."""
    port, ref = PageAllocator(num_pages, page_size), RAlloc(num_pages,
                                                            page_size)
    results = []
    for name, args in calls:
        outs = []
        for a in (port, ref):
            before = _state(a)
            try:
                outs.append(getattr(a, name)(*args))
            except RuntimeError as e:            # OutOfPages in both
                assert type(e).__name__ == "OutOfPages"
                assert _state(a) == before, name
                outs.append("OutOfPages")
        assert outs[0] == outs[1], (name, args, outs)
        assert _state(port) == _state(ref), (name, args)
        port.check()
        results.append(outs[0])
    return port, results


def test_adopt_shares_pages_and_free_keeps_sharer():
    a, res = _both_allocs(8, 4, [
        ("ensure", (1, 10)), ("commit", (1, 10)),
        ("adopt", (2, [0, 1], 8)), ("free", (1,)), ("free", (2,))])
    assert res[3] == [2] and res[4] == [0, 1]     # only exclusive pages
    assert a.free_pages == a.num_pages


def test_cow_detaches_shared_page():
    a, res = _both_allocs(8, 4, [
        ("ensure", (1, 8)), ("commit", (1, 8)), ("adopt", (2, [0, 1], 7)),
        ("cow", (2, 1)), ("cow", (2, 1)), ("shared_pages", ()),
        ("page_shared", (0,)), ("page_shared", (1,))])
    assert res[3] == (1, 2) and res[4] is None
    assert res[5] == 1 and res[6] and not res[7]
    assert a.tables == {1: [0, 1], 2: [0, 2]}


def test_cow_out_of_pages_mutates_nothing():
    a, res = _both_allocs(2, 4, [
        ("ensure", (1, 8)), ("commit", (1, 8)), ("adopt", (2, [0, 1], 7)),
        ("cow", (2, 0))])
    assert res[3] == "OutOfPages"
    with pytest.raises(OutOfPages):
        a.cow(2, 1)
    a.check()


def test_prefix_cache_lookup_verifies_tokens():
    donor = np.arange(2, 14, dtype=np.int32)          # 12 tokens, 3 pages
    diverged = donor.copy()
    diverged[9] = 77                                  # inside page 2
    collide = donor.copy()
    collide[0] = 99                                   # no aligned match
    queries = [np.concatenate([donor, [99, 98]]).astype(np.int32), diverged,
               donor, collide, donor[:5]]
    caches = []
    for alloc_cls, cache_cls in ((PageAllocator, PrefixCache),
                                 (RAlloc, RPrefixCache)):
        a, pc = alloc_cls(16, 4), cache_cls(4)
        pc.register(1, donor)
        a.ensure(1, 12)
        a.commit(1, 12)
        hits = [pc.lookup(q, a) for q in queries]
        hits.append(pc.lookup(donor, a, exclude=1))
        pc.forget(1)
        hits.append(pc.lookup(donor, a))              # forgotten donor
        pc.register(1, donor)
        a.free(1)
        hits.append(pc.lookup(donor, a))              # dead donor
        caches.append(hits)
    assert caches[0] == caches[1]
    hits = caches[0]
    assert hits[0] == (1, 12, [0, 1, 2])              # aligned + extension
    assert hits[1][1] == 9 and len(hits[1][2]) == 3   # diverged mid-page
    assert hits[2][1] == 11                           # capped at len - 1
    assert hits[3] is None and hits[4][1] == 4
    assert hits[5:] == [None, None, None]


# ---------------------------------------------------------------------------
# engine cases on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _sv(sharing, max_batch=2, **kw):
    return dict(page_size=8, max_batch=max_batch, max_len=96,
                prefill_token_budget=64, prefix_sharing=sharing, **kw)


def _port_engine(params, **sv):
    return PagedEngine(Config(model=PORT_CFG,
                              parallel=ParallelConfig(data=1, model=1),
                              iso=PORT_ISO, serving=ServingConfig(**sv)),
                       params, device="cpu")


def _dead_slots(eng):
    """(N+1, ps) bool: the slots no request holds inside its length."""
    live = torch.zeros(eng.kv.k[0].shape[1:3], dtype=torch.bool)
    for rid, table in eng.alloc.tables.items():
        n = eng.alloc.lengths.get(rid, 0)
        for j, pg in enumerate(table):
            live[pg, :max(0, min(eng.ps, n - j * eng.ps))] = True
    return ~live


def _poison(eng):
    """Fill every slot no request may read with NaN: after every copy on
    write, the copy's slots past the sharee's length (the donor's tail);
    after every step, every dead slot.  Returns the count of donor-tail
    slots poisoned."""
    tails = [0]
    copy = eng._copy_page

    def poisoned_copy(old, new):
        copy(old, new)
        rid = next(r for r, t in eng.alloc.tables.items() if new in t)
        j = eng.alloc.tables[rid].index(new)
        keep = max(0, eng.alloc.lengths.get(rid, 0) - j * eng.ps)
        tails[0] += eng.ps - min(keep, eng.ps)
        for pool in eng.kv.k + eng.kv.v:
            pool[:, new, keep:] = float("nan")

    step = eng.step

    def poisoned_step():
        events = step()
        dead = _dead_slots(eng)
        for pool in eng.kv.k + eng.kv.v:
            pool[:, dead] = float("nan")
        eng.alloc.check()
        return events

    eng._copy_page = poisoned_copy
    eng.step = poisoned_step
    return tails


def _serve(eng, prompts, news, request=Request, sampling=SamplingParams):
    rids = [eng.add_request(request(prompt=p.copy(), sampling=sampling(
        max_new_tokens=n, eos_id=-1))) for p, n in zip(prompts, news)]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids]


def _case(weights, prompts, news, **sv):
    """Tokens of the sharing port engine (poisoned), equal to the unpoisoned
    one, the reference's and the unshared port engine's; counters equal to
    the reference's.  Returns (sharing engine, unshared engine, donor-tail
    slots poisoned)."""
    ref_params, params = weights
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO,
                               serving=RServing(**_sv(True, **sv))),
                       ref_params)
    want = _serve(ref, prompts, news, RRequest, RSampling)
    clean = _port_engine(params, **_sv(True, **sv))
    eng = _port_engine(params, **_sv(True, **sv))
    tails = _poison(eng)
    plain = _port_engine(params, **_sv(False, **sv))
    assert _serve(clean, prompts, news) == want
    assert _serve(eng, prompts, news) == want
    assert _serve(plain, prompts, news) == want
    for k in ("prefix_shared_tokens", "cow_copies", "peak_used_pages",
              "prefill_calls", "prefill_pad_rows", "preemptions"):
        assert eng.metrics[k] == ref.metrics[k] == clean.metrics[k], k
    assert eng.alloc.free_pages == eng.alloc.num_pages
    assert eng.alloc.shared_pages() == 0
    return eng, plain, tails[0]


def test_shared_prompt_identical_tokens_fewer_pages(weights):
    rng = np.random.default_rng(11)
    system = rng.integers(2, 64, 40).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(2, 64, n)
                               .astype(np.int32)]) for n in (9, 13)]
    eng, plain, _ = _case(weights, prompts, (6, 6))
    assert eng.metrics["prefix_shared_tokens"] >= 40
    assert eng.metrics["peak_used_pages"] < plain.metrics["peak_used_pages"]


def test_identical_prompts_copy_on_write(weights):
    """An identical, not page-aligned prompt shares the donor's partial last
    page; the sharee's first write copies it, and the copy's donor tail past
    the sharee's length is never read."""
    rng = np.random.default_rng(12)
    p = rng.integers(2, 64, 37).astype(np.int32)
    eng, _, tails = _case(weights, [p, p], (6, 6))
    assert eng.metrics["prefix_shared_tokens"] > 0
    assert eng.metrics["cow_copies"] > 0
    assert tails > 0


def test_freeing_one_sharer_preserves_the_other(weights):
    rng = np.random.default_rng(13)
    system = rng.integers(2, 64, 32).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(2, 64, n)
                               .astype(np.int32)]) for n in (5, 7)]
    eng, _, _ = _case(weights, prompts, (3, 12))
    assert eng.metrics["prefix_shared_tokens"] > 0


def test_sharing_under_eviction_and_packs(weights):
    """Three sharers of a 28-token system prompt in a pool too small for
    all of them: packed prefill, deferred sharees, eviction of a donor, and
    copy-on-write at decode time."""
    rng = np.random.default_rng(14)
    system = rng.integers(2, 64, 28).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(2, 64, n)
                               .astype(np.int32)]) for n in (3, 6, 10)]
    eng, _, _ = _case(weights, prompts, (8, 8, 8), max_batch=3,
                      num_pages=8)
    assert eng.metrics["preemptions"] > 0
    assert eng.metrics["prefix_shared_tokens"] > 0
    assert eng.metrics["cow_copies"] > 0


def test_page_stats_equal_reference_every_step(weights):
    """``page_stats()`` after every step of a sharing trace (a shared head,
    an identical prompt that copies on write) equals the reference's: the
    allocator's stats and the live KV bytes exactly, the reserved KV bytes
    less the reference's ``pos`` pool, which the port does not keep."""
    ref_params, params = weights
    rng = np.random.default_rng(15)
    system = rng.integers(2, 64, 24).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(2, 64, n)
                               .astype(np.int32)]) for n in (13, 5)]
    prompts.append(prompts[0].copy())
    sv = _sv(True, max_batch=3)
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(**sv)),
                       ref_params)
    eng = _port_engine(params, **sv)
    # request ids come from one counter a process: events are compared by
    # the request's index
    index = []
    for e, request, sampling in ((ref, RRequest, RSampling),
                                 (eng, Request, SamplingParams)):
        index.append({e.add_request(request(prompt=p.copy(),
                                            sampling=sampling(
                                                max_new_tokens=5,
                                                eos_id=-1))): i
                      for i, p in enumerate(prompts)})
    pos_bytes = ref.kv.arrays["pos"].size * ref.kv.arrays["pos"].itemsize
    steps = shared_steps = 0
    while ref.scheduler.waiting or any(s is not None for s in ref.slots):
        assert [(index[0][r], t) for r, t in ref.step()] == \
            [(index[1][r], t) for r, t in eng.step()]
        want, got = ref.page_stats(), eng.page_stats()
        want["kv_bytes_reserved"] -= pos_bytes
        assert got == want, steps
        steps += 1
        shared_steps += got["shared_pages"] > 0
    assert shared_steps > 0
    assert not eng.scheduler.waiting and all(s is None for s in eng.slots)
    assert eng.metrics["cow_copies"] > 0
    assert eng.metrics["prefix_shared_tokens"] > 0
    assert eng.page_stats()["used_pages"] == 0
