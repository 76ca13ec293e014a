"""Disaggregated prefill/decode serving in the port (``serving/disagg.py``)
against the JAX reference's ``DisaggRouter`` and the port's own single
engine, fp32 on the CPU on bridged weights, case for case after the
single-mesh cases of tests/test_disagg.py:

  * mixed traffic (a draft-friendly prompt, random ones, a prefix-sharing
    pair) at spec_k 0 and 2, priority traffic under ``migrate_batch=1``,
    a sharing pair moved in one transfer, a decode pool that fits one
    request (migration defers, never preempts), one that forces a
    decode-side eviction (the victim bounces back), and prefill-side
    preemption: tokens equal to the JAX router's and to the port's single
    engine's, ``migration_stats()`` equal to the reference's apart from
    ``migration_us``;
  * after every router step ``PageAllocator.check()`` holds on both pools
    and every KV slot no request holds inside its length is filled with
    NaN: a migrated page's bytes past a request's length are never read;
  * phase purity (no decode closure on the prefill engine, no prefill
    closure on the decode engine), replay == registry on each engine, both
    pools drained, one set of weights under both engines, and the decode
    pool written in place by every attach (``data_ptr`` unchanged);
  * under TP a lone ``TPGroup`` raises (the router takes a
    ``DisaggGroup``), and the launcher's ``--disagg --tp 2`` serves on four
    gloo ranks with the tokens and migration counters of ``--disagg`` at
    tp=1 (tests/test_torch_disagg_tp.py holds the tp=2 router against the
    reference)."""
import re

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
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.disagg import DisaggRouter as RDisaggRouter  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.obs.replay import REPLAYABLE, replay_counters  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.disagg import DisaggRouter  # noqa: E402
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


def _sv(**kw):
    base = dict(page_size=8, max_batch=2, max_len=160,
                prefill_token_budget=16, disagg=True)
    base.update(kw)
    return base


def _config(**sv):
    return Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=1),
                  iso=PORT_ISO, serving=ServingConfig(**_sv(**sv)))


def _dead_slots(eng):
    """(N+1, ps) bool: the slots no request holds inside its length."""
    live = torch.zeros(eng.kv.k[0].shape[1:3], dtype=torch.bool)
    for rid, table in eng.alloc.tables.items():
        n = eng.alloc.lengths.get(rid, 0)
        for j, pg in enumerate(table):
            live[pg, :max(0, min(eng.ps, n - j * eng.ps))] = True
    return ~live


def _poison(eng):
    dead = _dead_slots(eng)
    for pool in eng.kv.k + eng.kv.v:
        pool[:, dead] = float("nan")


def _submit(eng, prompts, new, priorities, make_req, make_sp):
    return [eng.add_request(make_req(
        prompt=p.copy(), priority=priorities[i] if priorities else 0,
        sampling=make_sp(max_new_tokens=new, eos_id=-1)))
        for i, p in enumerate(prompts)]


def _port_router(params, prompts, new=8, priorities=None, **sv):
    """Serve on the port's router, checking both allocators and poisoning
    every dead KV slot with NaN after every step."""
    router = DisaggRouter(_config(**sv), params, prefill_device="cpu")
    ptrs = [t.data_ptr() for t in router.decode.kv.k + router.decode.kv.v]
    rids = _submit(router, prompts, new, priorities, Request, SamplingParams)
    for _ in range(2_000):
        router.step()
        for eng in (router.prefill, router.decode):
            eng.alloc.check()
            _poison(eng)
        if router.done():
            break
    assert router.done()
    assert ptrs == [t.data_ptr()
                    for t in router.decode.kv.k + router.decode.kv.v]
    outs = {st.request.rid: st.generated
            for st in router.prefill._finished + router.decode._finished}
    return [outs[r] for r in rids], router


def _ref_router(ref_params, prompts, new=8, priorities=None, **sv):
    router = RDisaggRouter(RConfig(model=REF_CFG,
                                   parallel=RParallel(data=1, model=1),
                                   iso=REF_ISO,
                                   serving=RServing(**_sv(**sv))),
                           ref_params)
    rids = _submit(router, prompts, new, priorities, RRequest, RSampling)
    outs = router.run_until_complete(max_steps=2_000)
    return [outs[r] for r in rids], router


def _single(params, prompts, new=8, priorities=None, **sv):
    eng = PagedEngine(_config(**sv), params, device="cpu")
    rids = _submit(eng, prompts, new, priorities, Request, SamplingParams)
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def _assert_conserved(eng):
    assert eng.trace.dropped == 0
    rep = replay_counters(eng.trace.events())
    for name in REPLAYABLE:
        if name in eng.metrics:
            assert rep[name] == eng.metrics[name], (name, rep[name],
                                                    eng.metrics[name])
    assert rep["pages_allocated"] - rep["pages_freed"] == \
        eng.alloc.used_pages


def _check_all(weights, prompts, new=8, priorities=None, **sv):
    """Port router == JAX router == port single engine, the stats equal the
    reference's less migration_us, and the router's invariants hold."""
    ref_params, params = weights
    got, router = _port_router(params, prompts, new, priorities, **sv)
    want, rrouter = _ref_router(ref_params, prompts, new, priorities, **sv)
    single, _ = _single(params, prompts, new, priorities, **sv)
    assert got == want, (got, want)
    assert got == single, (got, single)
    ms, rms = router.migration_stats(), rrouter.migration_stats()
    assert ms.pop("migration_us") > 0
    rms.pop("migration_us")
    assert ms == rms, (ms, rms)
    for eng in (router.prefill, router.decode):
        _assert_conserved(eng)
        assert eng.alloc.used_pages == 0
    spec_k = sv.get("spec_k", 0)
    assert router.prefill._decode_fns == {}
    assert router.decode._prefill_fns == {}
    assert set(router.decode._decode_fns) <= \
        {(1, 1)} | ({(spec_k + 1, 1)} if spec_k else set())
    assert router.decode._decode_fns, "decode engine never decoded"
    cap = router.prefill.max_prefill_compiles()
    assert cap is None or router.prefill.prefill_compile_count() <= cap
    assert not router._pending
    assert router.stats["migrated_requests"] == \
        sum(e.kind == "detach" for e in router.prefill.trace.events()) == \
        sum(e.kind == "attach" for e in router.decode.trace.events())
    # one set of weights under both engines
    a, b = router.prefill.params, router.decode.params
    assert a["embed"]["table"].data_ptr() == b["embed"]["table"].data_ptr()
    assert a["periods"][0][0]["mlp"]["w_up"].data_ptr() == \
        b["periods"][0][0]["mlp"]["w_up"].data_ptr()
    return router


def _mixed_prompts(rng):
    """Repetitive (draft-friendly), random, and a prefix-sharing pair."""
    shared = rng.integers(2, 64, 24).astype(np.int32)
    base = rng.integers(2, 64, 6).astype(np.int32)
    return [np.tile(base, 5)[:30],
            rng.integers(2, 64, 33).astype(np.int32),
            np.concatenate([shared, rng.integers(2, 64, 9).astype(np.int32)]),
            np.concatenate([shared, rng.integers(2, 64, 5).astype(np.int32)])]


# ---------------------------------------------------------------------------
# differential battery: port router == JAX router == single engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 2])
def test_disagg_matches_reference_and_single_engine(weights, spec_k):
    router = _check_all(weights, _mixed_prompts(np.random.default_rng(11)),
                        spec_k=spec_k)
    assert router.stats["migrated_requests"] == 4
    assert router.prefill.metrics["migrated_pages"] > 0
    assert router.prefill.metrics["prefix_shared_tokens"] > 0
    if spec_k:
        # the transferred draft state kept speculation alive
        assert router.decode.metrics["spec_calls"] > 0
        assert router.decode.accepted_per_call() > 1.0


def test_disagg_priority_policy_and_migrate_batch(weights):
    router = _check_all(weights, _mixed_prompts(np.random.default_rng(7)),
                        priorities=[0, 2, 1, 3],
                        scheduler_policy="priority", migrate_batch=1)
    assert router.prefill.metrics["migrations"] == \
        router.stats["migrated_requests"] == 4


def test_disagg_batched_transfer_keeps_sharing(weights):
    """A sharing pair migrates in ONE transfer: the shared pages are
    exported once and still shared (same page, refcount 2) after attach."""
    rng = np.random.default_rng(19)
    shared = rng.integers(2, 64, 24).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(2, 64, 5)]),
               np.concatenate([shared, rng.integers(2, 64, 9)])]
    prompts = [p.astype(np.int32) for p in prompts]
    seen = []
    attach = PagedEngine.attach_requests

    def spy(eng, transfer):
        attach(eng, transfer)
        if len(transfer.records) == 2:
            t = eng.alloc.tables
            r0, r1 = transfer.rids
            seen.append(sum(a == b for a, b in zip(t[r0], t[r1])))
    PagedEngine.attach_requests = spy
    try:
        _check_all(weights, prompts, max_batch=4, prefill_token_budget=128)
    finally:
        PagedEngine.attach_requests = attach
    assert seen and seen[0] >= 3, seen


# ---------------------------------------------------------------------------
# flow control: full decode pool, decode-side eviction, prefill preemption
# ---------------------------------------------------------------------------

def test_full_decode_pool_defers_never_preempts(weights):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(2, 64, n).astype(np.int32) for n in (30, 26, 21)]
    # 30 prompt + 8 new at ps 8 -> 5 pages; a 6-page decode pool fits one
    router = _check_all(weights, prompts, max_batch=3, num_pages=24,
                        decode_pool_pages=6)
    assert router.stats["deferrals"] > 0
    assert router.decode.metrics["preemptions"] == 0
    assert router.stats["bounce_backs"] == 0


def test_full_decode_pool_rejects_oversized_request(weights):
    router = DisaggRouter(_config(decode_pool_pages=2), weights[1],
                          prefill_device="cpu")
    with pytest.raises(ValueError, match="decode pool"):
        router.add_request(Request(
            prompt=np.arange(2, 60, dtype=np.int32),
            sampling=SamplingParams(max_new_tokens=8, eos_id=-1)))


def test_decode_side_eviction_bounces_back(weights):
    rng = np.random.default_rng(29)
    prompts = [rng.integers(2, 64, 16).astype(np.int32) for _ in range(2)]
    # 4 pages each at ps 4, up to 7 with 12 new tokens: 10 decode pages
    # take both, and their growth collides mid-decode
    router = _check_all(weights, prompts, new=12, page_size=4, max_len=80,
                        num_pages=40, decode_pool_pages=10)
    assert router.stats["bounce_backs"] > 0
    assert router.decode.metrics["preemptions"] == \
        router.stats["bounce_backs"]
    assert router.stats["migrated_requests"] > len(prompts)


def test_disagg_with_prefill_side_preemption(weights):
    rng = np.random.default_rng(31)
    prompts = [rng.integers(2, 64, 30).astype(np.int32) for _ in range(3)]
    router = _check_all(weights, prompts, new=6, num_pages=8, max_batch=3,
                        prefill_token_budget=64)
    assert router.prefill.metrics["preemptions"] > 0


# ---------------------------------------------------------------------------
# placement and what is not ported yet
# ---------------------------------------------------------------------------

def test_disagg_devices_on_the_host():
    assert mesh.disagg_devices("cpu") == (torch.device("cpu"),
                                          torch.device("cpu"), True)


def test_single_engine_takes_disagg_serving_config(weights):
    """``ServingConfig(disagg=True)`` at tp=1 no longer raises: a mixed
    engine serves with it as the reference's does."""
    got, eng = _single(weights[1], [np.arange(2, 30, dtype=np.int32)])
    assert eng.sv.disagg and len(got[0]) == 8


def test_disagg_under_tp_raises(weights, capsys):
    """Under TP the router runs on the two rank groups of a
    ``DisaggGroup``: a lone ``TPGroup`` still raises, and the launcher's
    ``--disagg --tp 2`` serves on four gloo ranks, printing the reference's
    disagg lines and the tokens the same command prints at tp=1."""
    group = mesh.TPGroup(rank=0, tp=2, device=torch.device("cpu"),
                         backend="gloo")
    with pytest.raises(TypeError, match="DisaggGroup"):
        DisaggRouter(_config(), weights[1], mesh=group)
    from repro_torch.launch import serve
    args = ["--arch", "qwen3-8b", "--preset", "tiny", "--paged", "--device",
            "cpu", "--dtype", "float32", "--requests", "3", "--prompt-len",
            "40", "--max-new", "4", "--prefill-budget", "16", "--disagg",
            "--decode-pool-pages", "12"]
    outs = {}
    for tp in ("1", "2"):
        assert serve.main(args + ["--tp", tp]) == 0
        outs[tp] = capsys.readouterr().out
    for out in outs.values():
        assert "disagg requests=3 new_tokens=12" in out
        assert "prefill phase: " in out and "decode phase: " in out
    assert "tp=2 " in outs["2"] and "decode_schedule=batch_split" in outs["2"]
    tokens = {tp: re.findall(r"rid \d+: (\[.*\])", out)
              for tp, out in outs.items()}
    assert len(tokens["1"]) == 3 and tokens["2"] == tokens["1"]
    migration = {tp: re.search(r"migration: .*", out).group(0).split()
                 for tp, out in outs.items()}
    # the same transfers, pages, deferrals and bounce-backs (not the µs)
    assert [f for f in migration["2"] if not f.startswith("us=")] == \
        [f for f in migration["1"] if not f.startswith("us=")]


def test_decode_phase_engine_admits_nothing(weights):
    eng = PagedEngine(_config(), weights[1], device="cpu", phase="decode")
    with pytest.raises(RuntimeError, match="attach_requests"):
        eng.add_request(Request(prompt=np.arange(2, 12, dtype=np.int32)))
    assert not eng.scheduler.runs_prefill and eng.scheduler.runs_decode


def test_engine_takes_an_injected_kv_pool(weights):
    """``PagedEngine(kv_pool=)``: an engine-external pool serves as the
    engine's own (the same tokens), narrates into the engine's ring, and a
    pool that does not fit the engine raises."""
    from repro_torch.serving.kvstate import KVPool
    cfg = _config(disagg=False)
    pool = KVPool.create(PORT_CFG, 40, 8, dtype=torch.float32, device="cpu")
    eng = PagedEngine(cfg, weights[1], device="cpu", kv_pool=pool)
    assert eng.pool is pool and pool.alloc.trace is eng.trace
    prompts = _mixed_prompts(np.random.default_rng(3))
    rids = _submit(eng, prompts, 6, None, Request, SamplingParams)
    outs = eng.run_until_complete()
    want, _ = _single(weights[1], prompts, new=6, disagg=False)
    assert [outs[r] for r in rids] == want
    assert any(e.kind == "alloc" for e in eng.trace.events())
    bad = KVPool.create(PORT_CFG, 40, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        PagedEngine(cfg, weights[1], device="cpu", kv_pool=bad)
