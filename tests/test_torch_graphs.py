"""The port engine's compiled closures (``PagedEngine._get_prefill`` /
``_get_decode``) against the reference engine's jitted ones and against
direct model calls, fp32 on the CPU at the ``tiny_dense`` size.

On the card each closure is captured once in a CUDA graph and replayed; on
the CPU the same bodies run eagerly over the same static buffers, so these
tests run the code the card replays:

  * on mixed traffic (resumed grants, forced and automatic split-KV, the
    batch-split fallback, bucketing off, packed grants with prefix sharing,
    speculative verify windows) the closure keys, the compile count and its
    bound equal the reference's ``_prefill_fns`` / ``_decode_fns`` /
    ``_decode_fallback_fns``, ``prefill_compile_count`` and
    ``max_prefill_compiles`` (tests/test_compile_guard.py), with equal
    greedy tokens;
  * two grants of one bucket at different starts, a fresh grant, and decode
    steps at different lengths give logits and page pools EQUAL to direct
    ``api.prefill`` / ``api.decode_step`` calls with int offsets (live
    pages; the scratch page takes pad tails);
  * a pack of grants through one (bucket, rows, all_fresh) closure, a pad
    row among them, equals a direct ``api.prefill`` of the same rows, and
    the copy-on-write page copy is one closure copying in place;
  * the bodies (batch-1 and packed prefill, decode, a verify window, the
    page copy) read no tensor back to the host (no ``.item()``, ``int()``,
    ``.cpu()``, ...), which a CUDA graph could not replay;
  * a second trace on the same engine reuses its closures and gives a fresh
    engine's tokens;
  * with a measured cost model (the forcing table of the reference's
    model-vs-static differential, which caps grants and splits the decode
    walk), the closure keys, the compile count and its bound equal the
    reference engine's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.perf.costmodel import CostModel as RCostModel  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.layers import embeddings as emb_lib  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.perf.costmodel import CostModel  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.paged_engine import StepClosure  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
BASE_SV = dict(page_size=8, max_batch=4, max_len=160,
               prefill_token_budget=24, prefix_sharing=False,
               prefill_batching=False)

# (name, prompt lengths, new tokens, serving kwargs over BASE_SV)
TRACES = [
    # straddles bucket boundaries; long prompts resume under the budget
    ("bucketed", (7, 9, 17, 33, 41, 70), 3, {}),
    ("splits2", (9, 17, 33, 41), 3, dict(decode_kv_splits=2)),
    # 120 tokens on 8-token pages: every decode step past 4 pages splits
    ("auto_deep", (120,), 3, dict(decode_kv_splits=0,
                                  decode_split_min_pages=4,
                                  decode_split_factor=4,
                                  prefill_token_budget=64)),
    # the batch drains to one request: the sequential fallback closure
    ("batch_split", (9, 33, 41), 4, dict(decode_schedule="batch_split")),
    ("unbucketed", (9, 17, 33), 3, dict(grant_bucketing=False)),
    # the reference's defaults: packed grants (length bucket, row bucket,
    # all-fresh) and prefix sharing, then with a verify window (K, S)
    ("packed_shared", (7, 9, 17, 33, 41, 70), 3,
     dict(prefill_batching=True, prefix_sharing=True)),
    ("packed_spec", (9, 17, 33, 41), 6,
     dict(prefill_batching=True, prefix_sharing=True, spec_k=2)),
    ("spec_batch1", (9, 17, 33), 6, dict(spec_k=3)),
]
# the packed_shared trace's last two prompts open with the first's 24 tokens
SHARED = {"packed_shared": 24, "packed_spec": 16}


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, ref)
    return ref, bridge.from_reference(host, device="cpu")


def _prompts(lengths, seed=0, shared=0):
    """Random prompts; with ``shared``, the last two open with the first
    ``shared`` tokens of the longest."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, 64, n).astype(np.int32) for n in lengths]
    if shared:
        head = max(prompts, key=len)[:shared]
        for p in prompts[-2:]:
            p[:min(shared, len(p) - 1)] = head[:min(shared, len(p) - 1)]
    return prompts


def _port_engine(params, **sv):
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=1),
                    iso=PORT_ISO,
                    serving=ServingConfig(**{**BASE_SV, **sv}))
    return PagedEngine(config, params, device="cpu")


def _serve(eng, prompts, new, request=Request, sampling=SamplingParams):
    rids = [eng.add_request(request(prompt=p.copy(), sampling=sampling(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids]


@pytest.mark.parametrize("name,lengths,new,sv", TRACES,
                         ids=[t[0] for t in TRACES])
def test_closure_keys_equal_reference(weights, name, lengths, new, sv):
    ref_params, params = weights
    prompts = _prompts(lengths, shared=SHARED.get(name, 0))
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO,
                               serving=RServing(**{**BASE_SV, **sv})),
                       ref_params)
    want = _serve(ref, prompts, new, RRequest, RSampling)
    eng = _port_engine(params, **sv)
    assert _serve(eng, prompts, new) == want
    if sv.get("prefill_batching"):
        # packed: (n_text, rows, all_fresh), the reference's own key
        assert set(eng._prefill_fns) == set(ref._prefill_fns)
        assert any(rows > 1 for _, rows, _ in eng._prefill_fns)
    else:
        # batch-1: the reference keys (n_text, n_patches, resumed)
        assert set(eng._prefill_fns) == {(n, r)
                                         for n, p, r in ref._prefill_fns}
    assert set(eng._decode_fns) == set(ref._decode_fns)
    assert set(eng._decode_fallback_fns) == set(ref._decode_fallback_fns)
    assert eng.prefill_compile_count() == ref.prefill_compile_count()
    assert eng.max_prefill_compiles() == ref.max_prefill_compiles()
    bound = eng.max_prefill_compiles()
    if name == "unbucketed":
        assert bound is None
    else:
        assert eng.prefill_compile_count() <= bound
    assert sum(eng.decode_splits.values()) == eng.metrics["decode_calls"]
    assert eng.metrics["resumed_grants"] > 0 or name == "unbucketed"
    for k in ("prefill_calls", "prefill_pad_rows", "prefix_shared_tokens",
              "cow_copies", "spec_calls", "spec_tokens"):
        assert eng.metrics[k] == ref.metrics[k], k
    if name in SHARED:
        assert eng.metrics["prefix_shared_tokens"] > 0
    if sv.get("spec_k"):
        assert eng.metrics["spec_calls"] > 0
        assert (sv["spec_k"] + 1, 1) in eng._decode_fns
    if name == "splits2":
        assert set(eng.decode_splits) == {2}
    if name == "batch_split":
        assert eng._decode_fallback_fns and eng._decode_fns
    assert eng.graphs == 0                 # the CPU captures nothing


# the forcing table of tests/test_costmodel.py's model-vs-static differential
FORCING = {
    "schema": "costmodel-v1", "version": 1, "platform": "cpu",
    "mesh": {"tp": 1}, "model": "t-dense", "page_size": 8,
    "alpha_beta": {"alpha_s": 1e-6, "beta_s_per_byte": 1e-10, "r2": 1.0},
    "prefill_us": {"16x1": 100.0, "16x2": 150.0, "32x1": 400.0,
                   "32x2": 500.0, "64x1": 900.0, "64x2": 1100.0},
    "decode_us": {"1/1/2": 100.0, "1/2/2": 40.0, "3/1/2": 5000.0,
                  "3/2/2": 5000.0, "1/1/16": 400.0, "1/2/16": 150.0,
                  "3/1/16": 5000.0, "3/2/16": 5000.0}}


@pytest.mark.parametrize("batched", [False, True], ids=["batch1", "packed"])
def test_closure_keys_equal_reference_with_cost_model(weights, batched):
    ref_params, params = weights
    sv = dict(prefill_batching=batched, prefix_sharing=batched, spec_k=2)
    prompts = _prompts((7, 9, 17, 33, 41, 70), shared=24 if batched else 0)
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO,
                               serving=RServing(**{**BASE_SV, **sv},
                                                cost_model=RCostModel(
                                                    FORCING))),
                       ref_params)
    want = _serve(ref, prompts, 6, RRequest, RSampling)
    eng = _port_engine(params, cost_model=CostModel(FORCING), **sv)
    assert _serve(eng, prompts, 6) == want
    if batched:
        assert set(eng._prefill_fns) == set(ref._prefill_fns)
    else:
        assert set(eng._prefill_fns) == {(n, r)
                                         for n, p, r in ref._prefill_fns}
    assert set(eng._decode_fns) == set(ref._decode_fns)
    assert any(s > 1 for _, s in eng._decode_fns)
    assert eng.prefill_compile_count() == ref.prefill_compile_count()
    assert eng.max_prefill_compiles() == ref.max_prefill_compiles()
    assert eng.prefill_compile_count() <= eng.max_prefill_compiles()
    # the grant cap held every grant to the best bucket, 16 tokens
    assert {n for n, *_ in eng._prefill_fns} == {16}
    assert [e.payload for e in eng.trace.events() if e.kind == "decision"] \
        == [e.payload for e in ref.trace.events() if e.kind == "decision"]


def _filled_engine(params, seed):
    """An engine on the CPU (page 8, 8 blocks a table) whose pools hold
    random KV, as if earlier grants had written them."""
    eng = _port_engine(params, max_len=64, max_batch=3)
    gen = torch.Generator().manual_seed(seed)
    for pool in eng.kv.k + eng.kv.v:
        pool.copy_(torch.randn(pool.shape, generator=gen))
    return eng


def _pools(eng):
    return [p.clone() for p in eng.kv.k + eng.kv.v]


def _live(pools, eng):
    """The pools without the scratch page, which takes the pad tail's and
    the inactive slots' KV and is never read."""
    return [p[:, :eng.kv.scratch_page] for p in pools]


def _restore(eng, saved):
    for pool, s in zip(eng.kv.k + eng.kv.v, saved):
        pool.copy_(s)


def _direct_prefill(eng, params, toks, bt, start, n_real, resumed):
    """One grant through ``api.prefill`` with int offsets, its KV scattered
    position by position: the eager path the closure replaces."""
    out = api.prefill(
        params, PORT_CFG, AxisCtx(), PORT_ISO,
        {"tokens": torch.from_numpy(toks)}, logits_mode="none",
        prefix_caches=eng._paged_prefix() if resumed else None,
        pos_offset=start,
        block_tables=torch.from_numpy(bt) if resumed else None,
        prefix_lens=torch.tensor([start], dtype=torch.int32)
        if resumed else None, valid_len=n_real, return_extras=True)
    logits = emb_lib.lm_head_local(params["embed"],
                                   out["hidden"][:, n_real - 1:n_real])[:, 0]
    ps = eng.ps
    for kv_i, i in enumerate(eng.kv.kv_positions):
        ex = out["extras"][i]
        for t in range(n_real):
            page, off = int(bt[0, (start + t) // ps]), (start + t) % ps
            eng.kv.k[kv_i][:, page, off] = ex["kv_k"][:, 0, t]
            eng.kv.v[kv_i][:, page, off] = ex["kv_v"][:, 0, t]
    return logits


# (start, real tokens, block-table row) of grants of one 16-token bucket
GRANTS = [(21, 13, [5, 2, 9, 0, -1, -1, -1, -1]),
          (10, 16, [3, 7, 1, -1, -1, -1, -1, -1]),
          (40, 9, [11, 4, 6, 8, 12, 14, -1, -1])]


@pytest.mark.parametrize("resumed", [True, False],
                         ids=["resumed", "fresh"])
def test_prefill_closure_equals_direct_calls(weights, resumed):
    """Grants of one bucket at different starts through ONE closure (its
    static buffers restaged each time) against direct calls: logits and
    every live page equal.  A fresh grant starts at 0."""
    _, params = weights
    eng = _filled_engine(params, seed=1)
    rng = np.random.default_rng(1)
    fn = eng._get_prefill(16, resumed)
    for start, n_real, row in GRANTS:
        start = start if resumed else 0
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n_real] = rng.integers(2, 64, n_real)
        bt = np.asarray([row], np.int32)
        saved = _pools(eng)
        fn.stage(tokens=toks, bt=bt, start=start, n_real=n_real)
        got = fn().clone()
        got_pools = _pools(eng)
        _restore(eng, saved)
        want = _direct_prefill(eng, params, toks, bt, start, n_real, resumed)
        assert torch.equal(got, want), (start, n_real)
        for g, w in zip(_live(got_pools, eng), _live(_pools(eng), eng)):
            assert torch.equal(g, w), (start, n_real)
    assert eng._get_prefill(16, resumed) is fn


@pytest.mark.parametrize("all_fresh", [False, True],
                         ids=["resumed", "all_fresh"])
def test_packed_closure_equals_direct_call(weights, all_fresh):
    """Two packs of one (16, 3, all_fresh) closure, each with a pad row,
    against a direct ``api.prefill`` of the same rows with the KV scattered
    row by row in Python: logits and every live page equal (the pad row
    writes only to the scratch page)."""
    _, params = weights
    eng = _filled_engine(params, seed=3)
    rng = np.random.default_rng(3)
    fn = eng._get_prefill_batched(16, 3, all_fresh)
    for rows in (GRANTS[:2], GRANTS[1:]):
        toks = np.zeros((3, 16), np.int32)
        bt = np.full((3, 8), -1, np.int32)
        starts = np.zeros(3, np.int32)
        n_reals = np.zeros(3, np.int32)
        for r, (start, n_real, row) in enumerate(rows):
            toks[r, :n_real] = rng.integers(2, 64, n_real)
            bt[r] = row
            starts[r] = 0 if all_fresh else start
            n_reals[r] = n_real
        saved = _pools(eng)
        fn.stage(tokens=toks, bt=bt, starts=starts, n_reals=n_reals)
        got = fn().clone()
        got_pools = _pools(eng)
        _restore(eng, saved)
        st = torch.from_numpy(starts)
        out = api.prefill(
            params, PORT_CFG, AxisCtx(), PORT_ISO,
            {"tokens": torch.from_numpy(toks)}, logits_mode="none",
            prefix_caches=None if all_fresh else eng._paged_prefix(),
            pos_offset=st,
            block_tables=None if all_fresh else torch.from_numpy(bt),
            prefix_lens=None if all_fresh else st,
            valid_len=torch.from_numpy(n_reals), return_extras=True)
        h = torch.stack([out["hidden"][r, max(int(n) - 1, 0)]
                         for r, n in enumerate(n_reals)])
        want = emb_lib.lm_head_local(params["embed"], h[:, None])[:, 0]
        for kv_i, i in enumerate(eng.kv.kv_positions):
            ex = out["extras"][i]
            for r in range(2):
                for t in range(int(n_reals[r])):
                    pos = int(starts[r]) + t
                    page, off = int(bt[r, pos // eng.ps]), pos % eng.ps
                    eng.kv.k[kv_i][:, page, off] = ex["kv_k"][:, r, t]
                    eng.kv.v[kv_i][:, page, off] = ex["kv_v"][:, r, t]
        assert torch.equal(got, want)
        for g, w in zip(_live(got_pools, eng), _live(_pools(eng), eng)):
            assert torch.equal(g, w)
    assert eng._get_prefill_batched(16, 3, all_fresh) is fn


def test_copy_page_closure_copies_in_place(weights):
    """Copy-on-write's page copy: one closure for every (old, new) pair,
    each call copying one page in every period's k and v pool in place (the
    pools keep their storage, which captured graphs point at)."""
    _, params = weights
    eng = _filled_engine(params, seed=5)
    ptrs = [p.data_ptr() for p in eng.kv.k + eng.kv.v]
    want = _pools(eng)
    fn = None
    for old, new in ((3, 7), (7, 11), (0, 2)):
        eng._copy_page(old, new)
        fn = fn or eng._copy_page_fn
        assert eng._copy_page_fn is fn
        for w in want:
            w[:, new] = w[:, old]
        for g, w in zip(_pools(eng), want):
            assert torch.equal(g, w)
    assert [p.data_ptr() for p in eng.kv.k + eng.kv.v] == ptrs
    assert eng.metrics["cow_copies"] == 3


# (tokens, lengths, decode mask) of decode steps at max_batch 3
STEPS = [([[5], [9], [0]], [20, 9, 0], [True, True, False]),
         ([[17], [3], [44]], [33, 0, 47], [True, False, True])]
TABLES = np.asarray([[3, 7, 1, 12, 13, 14, 15, -1],
                     [4, 10, -1, -1, -1, -1, -1, -1],
                     [0, 2, 5, 6, 8, 9, 11, -1]], np.int32)


@pytest.mark.parametrize("S", [1, 2], ids=["S1", "S2"])
def test_decode_closure_equals_direct_calls(weights, S):
    """Decode steps at different lengths through one (1, S) closure against
    direct ``api.decode_step`` calls: logits and every live page equal."""
    _, params = weights
    eng = _filled_engine(params, seed=2)
    fn = eng._get_decode(1, S)
    for toks, lens, mask in STEPS:
        toks = np.asarray(toks, np.int32)
        lens = np.asarray(lens, np.int32)
        mask = np.asarray(mask)
        bt = np.where(mask[:, None], TABLES, -1).astype(np.int32)
        saved = _pools(eng)
        fn.stage(toks=toks, lengths=lens, bt=bt, mask=mask)
        got = fn().clone()
        got_pools = _pools(eng)
        _restore(eng, saved)
        want, _ = api.decode_step(
            params, PORT_CFG, AxisCtx(), torch.from_numpy(toks),
            eng._paged_prefix(), torch.from_numpy(lens),
            block_tables=torch.from_numpy(bt),
            decode_mask=torch.from_numpy(mask), kv_splits=S)
        assert torch.equal(got, want)
        for g, w in zip(_live(got_pools, eng), _live(_pools(eng), eng)):
            assert torch.equal(g, w)


class _NoHostReads(TorchFunctionMode):
    """Raises on every way a tensor's value reaches the host, and on a
    tensor made from host data: a CUDA graph would bake the value read at
    capture into every replay."""
    BANNED = {"item", "__int__", "__float__", "__bool__", "__index__",
              "cpu", "tolist", "numpy", "tensor", "as_tensor",
              "from_numpy"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.BANNED:
            raise AssertionError(f"host read on the captured path: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", ["fresh", "resumed", "decode",
                                   "decode_split", "batch_split", "packed",
                                   "packed_fresh", "verify", "copy_page"])
def test_closure_bodies_read_nothing_back(weights, which):
    _, params = weights
    sv = dict(decode_schedule="batch_split") if which == "batch_split" \
        else {}
    eng = _port_engine(params, max_len=64, max_batch=3, **sv)
    if which == "copy_page":
        eng._copy_page(3, 5)                  # builds the closure
        fn = eng._copy_page_fn
        fn.stage(old=5, new=9)
        with _NoHostReads():
            fn()
        assert torch.equal(eng.kv.k[0][:, 9], eng.kv.k[0][:, 5])
        return
    if which in ("packed", "packed_fresh"):
        fn = eng._get_prefill_batched(16, 3, which == "packed_fresh")
        fn.stage(tokens=np.ones((3, 16), np.int32),
                 bt=np.asarray([row for _, _, row in GRANTS], np.int32),
                 starts=np.asarray([0 if which == "packed_fresh" else s
                                    for s, _, _ in GRANTS], np.int32),
                 n_reals=np.asarray([13, 0, 9], np.int32))
    elif which == "verify":
        fn = eng._get_decode(3, 2)
        toks, lens, mask = STEPS[0]
        fn.stage(toks=np.tile(np.asarray(toks), (1, 3)),
                 lengths=np.asarray(lens), bt=TABLES, mask=np.asarray(mask))
    elif which in ("fresh", "resumed"):
        start, n_real, row = GRANTS[0]
        fn = eng._get_prefill(16, which == "resumed")
        fn.stage(tokens=np.ones((1, 16), np.int32),
                 bt=np.asarray([row], np.int32),
                 start=start if which == "resumed" else 0, n_real=n_real)
    else:
        fn = eng._get_decode(1, 2 if which == "decode_split" else 1)
        toks, lens, mask = STEPS[0]
        fn.stage(toks=np.asarray(toks), lengths=np.asarray(lens),
                 bt=TABLES, mask=np.asarray(mask))
    with _NoHostReads():
        out = fn()
    assert torch.isfinite(out).all()


def test_second_trace_reuses_closures(weights):
    _, params = weights
    prompts = _prompts((7, 17, 33, 41, 70), seed=4)
    eng = _port_engine(params)
    first = _serve(eng, prompts, 4)
    fns = {**eng._prefill_fns, **{("d",) + k: f
                                  for k, f in eng._decode_fns.items()}}
    again = _serve(eng, prompts, 4)
    fresh = _serve(_port_engine(params), prompts, 4)
    assert again == fresh == first
    assert {**eng._prefill_fns, **{("d",) + k: f for k, f in
                                   eng._decode_fns.items()}} == fns
    assert eng.alloc.free_pages == eng.alloc.num_pages


def test_dropped_engine_is_freed_without_the_cycle_collector(weights):
    """Closure bodies hold the engine's params and pools, not the engine:
    with every closure kind built (packed and batch-1 prefill, decode and
    the page copy), dropping the last reference frees the engine, so its
    pools and graphs go with it, with the cycle collector off."""
    import gc
    import weakref
    _, params = weights
    engines = [_port_engine(params, prefill_batching=True,
                            prefix_sharing=True, spec_k=2,
                            prefill_token_budget=64),
               _port_engine(params)]
    # two identical prompts share a partial last page: a copy on write
    prompts = _prompts((37,), seed=5)
    prompts.append(prompts[0].copy())
    for eng in engines:
        _serve(eng, prompts, 4)
    assert engines[0]._copy_page_fn is not None
    assert any(len(k) == 3 for k in engines[0]._prefill_fns)
    assert any(len(k) == 2 for k in engines[1]._prefill_fns)
    refs = [weakref.ref(e) for e in engines]
    pools = [weakref.ref(e.kv.k[0]) for e in engines]
    gc.disable()
    try:
        del eng, engines
        assert [r() for r in refs + pools] == [None] * 4
    finally:
        gc.enable()


def test_uncaptured_graphed_closure_raises():
    """A graphed closure is never run eagerly in place of its graph."""
    calls = []
    buf = {"x": torch.zeros(2, dtype=torch.int32)}
    eager = StepClosure(buf, lambda: calls.append(1), graphed=False)
    eager()
    assert calls == [1]
    graphed = StepClosure(buf, lambda: calls.append(1), graphed=True)
    with pytest.raises(RuntimeError, match="before its capture"):
        graphed()
    assert calls == [1]


def test_launch_counts_round_trip():
    before = native.launch_counts()
    delta = {"paged_decode": 3, "paged_decode/fold": 3,
             "paged_prefill/tc": 2, "paged_prefill": 2}
    native.add_launches(delta)
    after = native.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == delta
    native.add_launches({k: -n for k, n in delta.items()})
    assert native.launch_counts() == before
