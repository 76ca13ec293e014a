"""Engine-external KV state in the port (``serving/kvstate.py``, the
allocator's and prefix cache's serialization in ``serving/kvcache.py``)
against the JAX reference, case for case after tests/test_kvstate.py:

  * ``PageAllocator.snapshot()/restore()`` round-trips exactly through
    JSON (tables, lengths, refcounts, the free list's order) and equals the
    reference's snapshot after the same operations, on a hand-built state
    and on random admission/grant/copy-on-write/free walks (seeded, and
    drawn by hypothesis);
  * ``PrefixCache.snapshot()/restore()`` rebuilds the hash index: lookups
    after restore find the reference's donors;
  * ``KVPool.export_pages``/``import_pages``: the blob's tables, lengths
    and page count equal the reference's, its payloads equal the
    reference's k/v (bit for bit on the same written values; within fp32
    tolerance on KV computed by each package's engine from the same
    traffic), a shared page is exported once and stays shared, the round
    trip is bit-exact in fp32 and bf16, an import writes the pools in place
    (every pool tensor's ``data_ptr`` unchanged), and an import that does
    not fit raises ``OutOfPages`` with nothing mutated."""
import json

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
from repro.serving.kvstate import KVPool as RKVPool  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import OutOfPages, PageAllocator, \
    PrefixCache  # noqa: E402
from repro_torch.serving.kvstate import KVPool  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})


def _alloc_state(a):
    return (dict(a.tables), dict(a.lengths), dict(a.refcount),
            list(a._free), set(a._free_set))


def _walk_step(allocs, rng) -> None:
    """One random op, applied to every allocator in ``allocs`` (the port's
    and the reference's in lockstep): grow+commit / free / adopt / CoW."""
    a = allocs[0]
    op = rng.integers(0, 4)
    live = sorted(a.tables)
    if op == 0:
        rid = int(rng.integers(0, 6))
        want = a.tokens(rid) + int(rng.integers(1, 9))
        for x in allocs:
            try:
                x.ensure(rid, want)
                x.commit(rid, want - x.tokens(rid))
            except Exception as e:            # both packages' OutOfPages
                assert type(e).__name__ == "OutOfPages", e
    elif op == 1 and live:
        rid = int(rng.choice(live))
        for x in allocs:
            x.free(rid)
    elif op == 2 and live:
        donor = int(rng.choice(live))
        rid = 100 + int(rng.integers(0, 1000))
        if rid not in a.tables and a.tables[donor]:
            k = int(rng.integers(1, len(a.tables[donor]) + 1))
            n = min(a.tokens(donor), k * a.page_size)
            pages = a.tables[donor][:k]
            for x in allocs:
                x.adopt(rid, list(pages), n)
    elif op == 3 and live:
        rid = int(rng.choice(live))
        if a.tables[rid]:
            blk = int(rng.integers(0, len(a.tables[rid])))
            for x in allocs:
                try:
                    x.cow(rid, blk)
                except Exception as e:        # both packages' OutOfPages
                    assert type(e).__name__ == "OutOfPages", e


# ---------------------------------------------------------------------------
# PageAllocator snapshot/restore
# ---------------------------------------------------------------------------

def test_snapshot_restore_exact_through_json():
    snaps = []
    for cls in (PageAllocator, RAlloc):
        a = cls(num_pages=12, page_size=4)
        a.ensure(1, 7)
        a.commit(1, 7)
        a.ensure(2, 10)
        a.commit(2, 10)
        a.adopt(3, a.tables[1][:1], 4)          # shared page: refcount 2
        a.cow(3, 0)                             # ...then diverged
        a.free(2)
        snap = json.loads(json.dumps(a.snapshot()))
        b = cls(num_pages=12, page_size=4)
        b.restore(snap)
        assert _alloc_state(b) == _alloc_state(a)
        b.check()
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_restore_preserves_free_list_order():
    a = PageAllocator(num_pages=10, page_size=4)
    a.ensure(1, 12)
    a.commit(1, 12)
    a.free(1)                                   # the free list has history
    b = PageAllocator(num_pages=10, page_size=4)
    b.restore(json.loads(json.dumps(a.snapshot())))
    r = RAlloc(num_pages=10, page_size=4)
    r.restore(json.loads(json.dumps(a.snapshot())))
    for rid in (7, 8):
        for x in (a, b, r):
            x.ensure(rid, 8)
        assert a.tables[rid] == b.tables[rid] == r.tables[rid]


def test_restore_rejects_geometry_mismatch():
    snap = PageAllocator(num_pages=8, page_size=4).snapshot()
    with pytest.raises(AssertionError):
        PageAllocator(num_pages=9, page_size=4).restore(snap)
    with pytest.raises(AssertionError):
        PageAllocator(num_pages=8, page_size=8).restore(snap)


def test_random_walk_round_trip_seeded():
    """400-op random walk on the port's and the reference's allocators in
    lockstep; every 25 ops the snapshots are equal and restore exactly."""
    rng = np.random.default_rng(5)
    a, r = PageAllocator(num_pages=12, page_size=4), \
        RAlloc(num_pages=12, page_size=4)
    for i in range(400):
        _walk_step((a, r), rng)
        if i % 25 == 0:
            a.check()
            assert a.snapshot() == r.snapshot()
            b = PageAllocator(num_pages=12, page_size=4)
            b.restore(json.loads(json.dumps(a.snapshot())))
            assert _alloc_state(b) == _alloc_state(a)


def test_random_walk_round_trip_hypothesis():
    pytest.importorskip("hypothesis", reason="property tests need hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(5, 80))
    def walk(seed, n_ops):
        rng = np.random.default_rng(seed)
        a, r = PageAllocator(num_pages=10, page_size=4), \
            RAlloc(num_pages=10, page_size=4)
        for _ in range(n_ops):
            _walk_step((a, r), rng)
        a.check()
        assert a.snapshot() == r.snapshot()
        b = PageAllocator(num_pages=10, page_size=4)
        b.restore(json.loads(json.dumps(a.snapshot())))
        assert _alloc_state(b) == _alloc_state(a)
        b.check()
        for rid in sorted(b.tables):            # no latent double free
            b.free(rid)
        assert b.used_pages == 0 and b.free_pages == b.num_pages

    walk()


# ---------------------------------------------------------------------------
# PrefixCache snapshot/restore
# ---------------------------------------------------------------------------

def test_prefix_cache_round_trip_rebuilds_index():
    ps = 4
    prompt = np.arange(2, 14, dtype=np.int32)          # 12 tokens = 3 pages
    probe = np.concatenate([prompt[:8], np.asarray([50, 51], np.int32)])
    hits = []
    for alloc_cls, pc_cls in ((PageAllocator, PrefixCache),
                              (RAlloc, RPrefixCache)):
        a = alloc_cls(num_pages=12, page_size=ps)
        pc = pc_cls(ps)
        a.ensure(1, len(prompt))
        a.commit(1, len(prompt))
        pc.register(1, prompt)
        pc2 = pc_cls(ps)
        pc2.restore(json.loads(json.dumps(pc.snapshot())))
        hits += [pc.lookup(probe, a, exclude=2), pc2.lookup(probe, a,
                                                            exclude=2)]
        assert pc2.snapshot() == pc.snapshot()
    assert hits[0] is not None and hits[0][0] == 1
    assert all(h == hits[0] for h in hits), hits
    # the port's snapshot restores into the reference's cache and back
    r = RPrefixCache(ps)
    port = PrefixCache(ps)
    port.register(1, prompt)
    r.restore(json.loads(json.dumps(port.snapshot())))
    assert r.snapshot() == port.snapshot()


# ---------------------------------------------------------------------------
# KVPool export/import
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pools(num_pages=8, ps=4, dtype="float32"):
    td, jd = DTYPES[dtype]
    return (KVPool.create(PORT_CFG, num_pages, ps, dtype=td, device="cpu"),
            RKVPool.create(REF_CFG, num_pages, ps, dtype=jd))


def _fill(pair, rid, n_tokens, rng):
    """Allocate + commit ``rid`` on both pools and write the same
    recognizable payloads into its pages (the reference's ``pos`` too)."""
    port, ref = pair
    for p in pair:
        p.alloc.ensure(rid, n_tokens)
        p.alloc.commit(rid, n_tokens)
    pgs = port.alloc.tables[rid]
    assert pgs == ref.alloc.tables[rid]
    arrays = dict(ref.kv.arrays)
    for name, pools in (("k", port.kv.k), ("v", port.kv.v)):
        new = []
        for pool, rarr in zip(pools, arrays[name]):
            vals = rng.standard_normal((pool.shape[0], len(pgs))
                                       + tuple(pool.shape[2:]))
            pool[:, pgs] = torch.from_numpy(vals).to(pool.dtype)
            new.append(rarr.at[:, jnp.asarray(pgs)].set(
                jnp.asarray(vals, rarr.dtype)))
        arrays[name] = tuple(new)
    pos = np.full((len(pgs), ref.page_size), -1, np.int32)
    flat = np.arange(n_tokens)
    pos[flat // ref.page_size, flat % ref.page_size] = flat
    arrays["pos"] = arrays["pos"].at[jnp.asarray(pgs)].set(jnp.asarray(pos))
    ref.kv.arrays = arrays


def _payload(pool, rid):
    """rid's (k, v) gathered through its block table, as torch tensors."""
    pgs = pool.alloc.tables[rid]
    return ([k[:, pgs].clone() for k in pool.kv.k],
            [v[:, pgs].clone() for v in pool.kv.v])


def _blob_torch(blob, name):
    """The blob's ``name`` payloads as torch tensors of the pool's dtype."""
    dtype = DTYPES[blob["dtype"]][0]
    return [torch.from_numpy(a).view(dtype) for a in blob["pages"][name]]


def _bits(t):
    """``t``'s bit pattern (NaN-safe bit-exact comparisons)."""
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def _ptrs(pool):
    return [t.data_ptr() for t in pool.kv.k + pool.kv.v]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_import_round_trip_payloads_and_sharing(dtype):
    rng = np.random.default_rng(3)
    src = _pools(dtype=dtype)
    _fill(src, 1, 7, rng)
    # rid 2 shares rid 1's first page (CoW prefix sharing), then owns one
    for p in src:
        p.alloc.adopt(2, p.alloc.tables[1][:1], 4)
        p.alloc.ensure(2, 6)
        p.alloc.commit(2, 2)
    port, ref = src
    before = _alloc_state(port.alloc)
    kv_before = [t.clone() for t in port.kv.k + port.kv.v]

    blob, rblob = port.export_pages([1, 2]), ref.export_pages([1, 2])
    # shared page exported ONCE; tables, lengths and the page count are
    # the reference's
    assert blob["n_pages"] == rblob["n_pages"] == 3
    assert blob["tables"] == rblob["tables"]
    assert blob["lengths"] == rblob["lengths"] == {1: 7, 2: 6}
    assert blob["dtype"] == dtype and "pos" not in blob["pages"]
    # payloads equal the reference's k/v bit for bit (the same values)
    for name in ("k", "v"):
        for got, want in zip(_blob_torch(blob, name), rblob["pages"][name]):
            want = torch.tensor(np.asarray(want, np.float32)).to(
                got.dtype)
            assert torch.equal(got, want)
    # the source is untouched by an export
    assert _alloc_state(port.alloc) == before
    assert all(torch.equal(a, b) for a, b in
               zip(kv_before, port.kv.k + port.kv.v))
    # through JSON-free host state and back: a fresh pool adopts it
    dst = _pools(dtype=dtype)[0]
    ptrs = _ptrs(dst)
    dst.import_pages(blob)
    assert _ptrs(dst) == ptrs, "an import must write the pools in place"
    assert dst.alloc.tables[1][0] == dst.alloc.tables[2][0]
    assert dst.alloc.refcount[dst.alloc.tables[1][0]] == 2
    assert dst.alloc.tokens(1) == 7 and dst.alloc.tokens(2) == 6
    dst.alloc.check()
    for rid in (1, 2):                          # bit-exact
        sk, sv = _payload(port, rid)
        dk, dv = _payload(dst, rid)
        for a, b in zip(sk + sv, dk + dv):
            assert torch.equal(_bits(a), _bits(b))
    # the scratch page is untouched
    for pool in dst.kv.k + dst.kv.v:
        assert not pool[:, dst.kv.scratch_page].any()


def test_import_out_of_pages_is_atomic():
    rng = np.random.default_rng(4)
    src = _pools(num_pages=8)
    _fill(src, 1, 13, rng)                      # 4 pages
    blob = src[0].export_pages([1])
    dst = _pools(num_pages=8)
    _fill(dst, 9, 21, rng)                      # 6 pages -> only 2 free
    port = dst[0]
    before = _alloc_state(port.alloc)
    kv_before = [t.clone() for t in port.kv.k + port.kv.v]
    with pytest.raises(OutOfPages):
        port.import_pages(blob)
    with pytest.raises(Exception, match="import needs 4 pages, 2 free"):
        dst[1].import_pages(src[1].export_pages([1]))
    assert _alloc_state(port.alloc) == before
    assert all(torch.equal(a, b) for a, b in
               zip(kv_before, port.kv.k + port.kv.v))
    # once the blocker clears (its pages scrubbed to zero), the SAME
    # transfer imports cleanly
    released = port.alloc.free(9)
    port.scrub(released)
    for pool in port.kv.k + port.kv.v:
        assert not pool[:, released].any()
    port.import_pages(blob)
    assert port.alloc.tokens(1) == 13
    port.alloc.check()


def test_import_rejects_live_rid_and_page_size_mismatch():
    rng = np.random.default_rng(6)
    src = _pools()
    _fill(src, 1, 5, rng)
    blob = src[0].export_pages([1])
    dst = _pools()
    _fill(dst, 1, 5, rng)                       # rid 1 already live
    with pytest.raises(AssertionError):
        dst[0].import_pages(blob)
    other = KVPool.create(PORT_CFG, 8, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(AssertionError):
        other.import_pages(blob)
    bf16 = _pools(dtype="bfloat16")[0]
    with pytest.raises(AssertionError):
        bf16.import_pages(blob)                 # fp32 payload, bf16 pool


def test_stats_equal_reference_less_pos():
    rng = np.random.default_rng(8)
    pair = _pools(num_pages=10)
    _fill(pair, 1, 9, rng)
    _fill(pair, 2, 5, rng)
    got, want = pair[0].stats(), pair[1].stats()
    # the reference's pool bytes include its int32 pos pool
    pos_bytes = want.pop("kv_bytes_reserved") - got.pop("kv_bytes_reserved")
    assert pos_bytes == pair[1].kv.arrays["pos"].size * 4
    live_pos = pair[1].alloc.used_pages * pair[1].page_size * 4
    assert want.pop("kv_bytes_live") - got.pop("kv_bytes_live") in \
        (0, live_pos)
    assert got == want


# ---------------------------------------------------------------------------
# export on real traffic: both packages' engines, the same requests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def test_export_equals_reference_on_same_traffic(weights):
    """Both engines serve the same requests (a prefix-sharing pair among
    them) for a few steps; exporting the resident requests gives the
    reference's tables, lengths and page count, and payloads within fp32
    tolerance of the reference's KV.  Imported into a fresh port pool, the
    payload is the source's bit for bit."""
    ref_params, params = weights
    sv = dict(page_size=8, max_batch=3, max_len=96, prefill_token_budget=64)
    rng = np.random.default_rng(12)
    shared = rng.integers(2, 64, 20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(2, 64, 7)]),
               np.concatenate([shared, rng.integers(2, 64, 11)]),
               rng.integers(2, 64, 30)]
    prompts = [p.astype(np.int32) for p in prompts]
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=ISOConfig(enabled=True, num_chunks=2,
                                           min_chunk_tokens=8,
                                           chunk_align=8),
                             serving=ServingConfig(**sv)), params,
                      device="cpu")
    reng = RPagedEngine(RConfig(model=REF_CFG,
                                parallel=RParallel(data=1, model=1),
                                iso=iso_cfg(2, min_chunk_tokens=8,
                                            chunk_align=8),
                                serving=RServing(**sv)), ref_params)
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=6, eos_id=-1))) for p in prompts]
    rrids = [reng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=6, eos_id=-1))) for p in prompts]
    for _ in range(3):
        eng.step()
        reng.step()
    live = [i for i, r in enumerate(rids) if r in eng.alloc.tables]
    assert len(live) == 3
    blob = eng.pool.export_pages([rids[i] for i in live])
    rblob = reng.pool.export_pages([rrids[i] for i in live])
    remap = dict(zip(rrids, rids))
    assert blob["n_pages"] == rblob["n_pages"]
    assert blob["n_pages"] < sum(len(t) for t in blob["tables"].values()), \
        "the sharing pair's common pages must be exported once"
    assert blob["tables"] == {remap[r]: t for r, t in rblob["tables"].items()}
    assert blob["lengths"] == {remap[r]: n
                               for r, n in rblob["lengths"].items()}
    # live slots only: the reference's pos marks which slots hold KV
    pos = np.asarray(rblob["pages"]["pos"]) >= 0
    for name in ("k", "v"):
        for got, want in zip(blob["pages"][name], rblob["pages"][name]):
            np.testing.assert_allclose(got[:, pos], np.asarray(want)[:, pos],
                                       rtol=1e-5, atol=1e-5)
    dst = KVPool.create(PORT_CFG, 32, 8, dtype=torch.float32, device="cpu")
    dst.import_pages(blob)
    for rid in blob["tables"]:
        sk, sv_ = _payload(eng.pool, rid)
        dk, dv = _payload(dst, rid)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(sk + sv_, dk + dv))
