"""The port engine's compiled closures (``PagedEngine._get_prefill`` /
``_get_decode``) against the reference engine's jitted ones and against
direct model calls, fp32 on the CPU at the ``tiny_dense`` size.

On the card each closure is captured once in a CUDA graph and replayed; on
the CPU the same bodies run eagerly over the same static buffers, so these
tests run the code the card replays:

  * on mixed traffic (resumed grants, forced and automatic split-KV, the
    batch-split fallback, bucketing off) the closure keys, the compile count
    and its bound equal the reference's ``_prefill_fns`` / ``_decode_fns`` /
    ``_decode_fallback_fns``, ``prefill_compile_count`` and
    ``max_prefill_compiles`` (tests/test_compile_guard.py), with equal
    greedy tokens;
  * two grants of one bucket at different starts, a fresh grant, and decode
    steps at different lengths give logits and page pools EQUAL to direct
    ``api.prefill`` / ``api.decode_step`` calls with int offsets (live
    pages; the scratch page takes pad tails);
  * the bodies read no tensor back to the host (no ``.item()``, ``int()``,
    ``.cpu()``, ...), which a CUDA graph could not replay;
  * a second trace on the same engine reuses its closures and gives a fresh
    engine's tokens."""
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
]


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, ref)
    return ref, bridge.from_reference(host, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


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
    prompts = _prompts(lengths)
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO,
                               serving=RServing(**{**BASE_SV, **sv})),
                       ref_params)
    want = _serve(ref, prompts, new, RRequest, RSampling)
    eng = _port_engine(params, **sv)
    assert _serve(eng, prompts, new) == want
    # the reference keys prefill (n_text, n_patches, resumed); text only
    assert set(eng._prefill_fns) == {(n, r) for n, p, r in ref._prefill_fns}
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
    if name == "splits2":
        assert set(eng.decode_splits) == {2}
    if name == "batch_split":
        assert eng._decode_fallback_fns and eng._decode_fns
    assert eng.graphs == 0                 # the CPU captures nothing


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
                                   "decode_split", "batch_split"])
def test_closure_bodies_read_nothing_back(weights, which):
    _, params = weights
    sv = dict(decode_schedule="batch_split") if which == "batch_split" \
        else {}
    eng = _port_engine(params, max_len=64, max_batch=3, **sv)
    if which in ("fresh", "resumed"):
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
