"""Disaggregated serving under tensor parallelism (``serving/disagg.py`` with
``mesh=``, a ``launch.mesh.DisaggGroup``): a prefill group and a decode
group of two ranks each, four gloo ranks on the CPU, fp32, against the JAX
reference.

One ``mesh.spawn(..., disagg=True)`` runs every case in turn inside the
ranks, each rank on its shard of the reference's tp=2 weights:

  * the reference's own two-mesh traffic (tests/test_disagg.py
    ``test_disagg_two_meshes_subprocess``: the tiny dense twin, 4/2 heads,
    the shared-prefix pair first, budget 64, page 8, max_batch 2): tokens
    equal the JAX single-device ``PagedEngine``'s, 3 requests migrated,
    prefix sharing on the prefill group, and the two engines' closures
    kept apart;
  * a prompt longer than the budget (resumed grants: the paged prefill
    kernel's plain version on the prefill ranks), a decode pool so small
    that migration defers and a decode-side eviction bounces back, a first
    attach that fails (the deferred transfer retried), and the no-drop MoE
    twin: tokens and ``migration_stats()`` (less ``migration_us``) equal
    the JAX ``DisaggRouter``'s at tp=1, counter for counter;
  * ``quantized_comm``: the int8 reduce changes the numbers, so the router
    is held against the port's mixed tp=2 engine with the same reduces,
    which each group serves by itself in the same spawn;
  * on every rank and in every case: the same tokens and counters, the
    allocator's ``check()`` after every router step, every dead KV slot
    poisoned with NaN after every step (a migrated page's bytes past a
    request's length are never read), the decode pool written in place,
    and replay == registry on the rank's engine.

Tolerance: token equality; counters equal."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_moe  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.disagg import DisaggRouter as RDisaggRouter  # noqa: E402
from repro.serving.kvcache import OutOfPages as ROutOfPages  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, MoEConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

torch.set_num_threads(1)

TP = 2
TWINS = {"dense": tiny_dense(), "moe": tiny_moe()}
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)


def _two_mesh_prompts():
    """tests/test_disagg.py's two-mesh traffic: the sharing pair first."""
    rng = np.random.default_rng(3)
    shared = rng.integers(2, 64, 24).astype(np.int32)
    return [np.concatenate([shared, rng.integers(2, 64, 9).astype(np.int32)]),
            np.concatenate([shared, rng.integers(2, 64, 5).astype(np.int32)]),
            rng.integers(2, 64, 33).astype(np.int32)]


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


# name -> twin, prompts, new tokens, serving fields, iso fields, and whether
# the first attach raises OutOfPages
CASES = {
    "two_mesh": ("dense", _two_mesh_prompts(), 6,
                 dict(page_size=8, max_batch=2, max_len=160,
                      prefill_token_budget=64), {}, False),
    # 40 and 33 tokens over a 16-token budget: resumed grants
    "resumed": ("dense", _prompts((40, 33, 12), 11), 8,
                dict(page_size=8, max_batch=2, max_len=160,
                     prefill_token_budget=16), {}, False),
    # 16 + 12 tokens take up to 7 pages at page 4: a 10-page decode pool
    # defers the third request and evicts one of two growing ones
    "defer_bounce": ("dense", _prompts((16, 16, 16), 29), 12,
                     dict(page_size=4, max_batch=3, max_len=80, num_pages=40,
                          decode_pool_pages=10, prefill_token_budget=16),
                     {}, False),
    "retry": ("dense", _prompts((30, 21), 13), 6,
              dict(page_size=8, max_batch=2, max_len=160,
                   prefill_token_budget=64), {}, True),
    "moe": ("moe", _prompts((30, 21, 9), 17), 6,
            dict(page_size=8, max_batch=2, max_len=160,
                 prefill_token_budget=16), {}, False),
    "quantized": ("dense", _prompts((30, 21, 9), 19), 6,
                  dict(page_size=8, max_batch=2, max_len=160,
                       prefill_token_budget=16), dict(quantized_comm=True),
                  False),
}


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f: getattr(ref_cfg, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "qk_norm", "block_pattern")}
    if ref_cfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return ModelConfig(**kw)


def _port_config(twin, sv, iso, disagg=True):
    return Config(model=port_cfg(TWINS[twin]),
                  parallel=ParallelConfig(data=1, model=TP),
                  iso=dataclasses.replace(PORT_ISO, **iso),
                  serving=ServingConfig(**sv, disagg=disagg))


def _poison(eng):
    """NaN into every KV slot no request holds inside its length."""
    live = torch.zeros(eng.kv.k[0].shape[1:3], dtype=torch.bool)
    for rid, table in eng.alloc.tables.items():
        n = eng.alloc.lengths.get(rid, 0)
        for j, pg in enumerate(table):
            live[pg, :max(0, min(eng.ps, n - j * eng.ps))] = True
    for pool in eng.kv.k + eng.kv.v:
        pool[:, ~live] = float("nan")


def _submit(eng, prompts, new, make_req, make_sp):
    return [eng.add_request(make_req(prompt=p.copy(), sampling=make_sp(
        max_new_tokens=new, eos_id=-1))) for p in prompts]


def _serve_case(group, params, name):
    """One case on this rank: the router's tokens, counters and closures
    (and, under quantized_comm, the mixed tp=2 engine's tokens)."""
    from repro_torch.obs.replay import REPLAYABLE, replay_counters
    from repro_torch.serving import PagedEngine, Request
    from repro_torch.serving.disagg import DisaggRouter
    from repro_torch.serving.kvcache import OutOfPages
    from repro_torch.serving.requests import SamplingParams
    twin, prompts, new, sv, iso, fail_first = CASES[name]
    out = {}
    if iso.get("quantized_comm"):
        eng = PagedEngine(_port_config(twin, sv, iso, disagg=False),
                          params[twin], mesh=group.tp_group)
        rids = _submit(eng, prompts, new, Request, SamplingParams)
        done = eng.run_until_complete()
        out["mixed_tokens"] = [done[r] for r in rids]
    router = DisaggRouter(_port_config(twin, sv, iso), params[twin],
                          mesh=group)
    eng = router.prefill if group.role == "prefill" else router.decode
    other = router.decode if group.role == "prefill" else router.prefill
    assert other is None and eng.tp == TP and eng.phase == group.role
    ptrs = [t.data_ptr() for t in eng.kv.k + eng.kv.v]
    attach = PagedEngine.attach_requests
    calls = [0]

    def fail_once(engine, transfer):
        calls[0] += 1
        if calls[0] == 1:
            raise OutOfPages("forced")
        return attach(engine, transfer)
    if fail_first:
        PagedEngine.attach_requests = fail_once
    try:
        rids = _submit(router, prompts, new, Request, SamplingParams)
        steps = 0
        while not router.done():
            router.step()
            eng.alloc.check()
            _poison(eng)
            steps += 1
            assert steps < 2_000
        tokens = router.outputs()
    finally:
        PagedEngine.attach_requests = attach
    assert ptrs == [t.data_ptr() for t in eng.kv.k + eng.kv.v]
    assert eng.alloc.used_pages == 0 and not router._pending
    rep = replay_counters(eng.trace.events())
    for k in REPLAYABLE:
        if k in eng.metrics:
            assert rep[k] == eng.metrics[k], (k, rep[k], eng.metrics[k])
    stats = router.migration_stats()
    assert stats.pop("migration_us") > 0
    out.update(
        tokens=[tokens[r] for r in rids], stats=stats,
        metrics={k: eng.metrics[k] for k in (
            "prefix_shared_tokens", "resumed_grants", "preemptions",
            "migrations", "decode_calls", "prefill_calls")},
        prefill_keys=sorted(eng._prefill_fns, key=str),
        decode_keys=sorted(eng._decode_fns, key=str),
        wire=dict(router.wire), attach_calls=calls[0])
    return out


def _rank_job(group, npz):
    params = {k: bridge.shard_params(bridge.load_npz(p), group.tp_group.rank,
                                     TP) for k, p in npz.items()}
    return {"role": group.role, "peer": group.peer,
            "global_rank": group.global_rank, "tp_rank": group.tp_group.rank,
            "cases": {name: _serve_case(group, params, name)
                      for name in CASES}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, the reference's whole tp=2 params)."""
    ref, npz = {}, {}
    for name, cfg in TWINS.items():
        ref[name] = r_api.init_params(jax.random.PRNGKey(0), cfg, tp=TP,
                                      dtype=jnp.float32)
        npz[name] = str(tmp_path_factory.mktemp(name) / "params.npz")
        bridge.save_npz(npz[name], jax.tree_util.tree_map(np.asarray,
                                                          ref[name]))
    ranks = mesh.spawn(_rank_job, TP, args=(npz,), device="cpu",
                       timeout_s=300, disagg=True)
    return ranks, ref


def _ref_config(twin, sv):
    return RConfig(model=TWINS[twin], parallel=RParallel(data=1, model=1),
                   iso=REF_ISO, serving=RServing(**sv, disagg=True))


def _ref_router(params, name):
    twin, prompts, new, sv, _, fail_first = CASES[name]
    router = RDisaggRouter(_ref_config(twin, sv), params[twin])
    attach = RPagedEngine.attach_requests
    calls = [0]

    def fail_once(engine, transfer):
        calls[0] += 1
        if calls[0] == 1:
            raise ROutOfPages("forced")
        return attach(engine, transfer)
    if fail_first:
        RPagedEngine.attach_requests = fail_once
    try:
        rids = _submit(router, prompts, new, RRequest, RSampling)
        outs = router.run_until_complete(max_steps=2_000)
    finally:
        RPagedEngine.attach_requests = attach
    stats = router.migration_stats()
    stats.pop("migration_us")
    return [outs[r] for r in rids], stats


def _same_on_every_rank(ranks, name):
    runs = [r["cases"][name] for r in ranks]
    for r, run in enumerate(runs):
        assert run["tokens"] == runs[0]["tokens"], (name, r)
        assert run["stats"] == runs[0]["stats"], (name, r)
    return runs


def test_disagg_groups_and_peers(runs):
    ranks, _ = runs
    assert [(r["role"], r["tp_rank"], r["peer"]) for r in ranks] == [
        ("prefill", 0, 2), ("prefill", 1, 3), ("decode", 0, 0),
        ("decode", 1, 1)]
    assert [r["global_rank"] for r in ranks] == [0, 1, 2, 3]


def test_disagg_spawn_needs_two_groups_of_cards(monkeypatch):
    """Bare ``cuda`` puts each of the 2 x tp ranks on its own card over
    NCCL: with fewer cards the spawn refuses before starting a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="4 ranks over NCCL needs 4 cards"):
        mesh.spawn(_rank_job, TP, args=({},), device="cuda", disagg=True)
    with pytest.raises(ValueError, match="data must be 1"):
        mesh.spawn(_rank_job, TP, device="cpu", disagg=True, data=2)


def test_two_mesh_traffic_equals_reference_single_engine(runs):
    """The reference's two-mesh case at tp=2: the JAX single-device
    ``PagedEngine``'s tokens, every request migrated, sharing kept, and
    each group's engine compiled only its phase's closures."""
    ranks, ref = runs
    twin, prompts, new, sv, _, _ = CASES["two_mesh"]
    eng = RPagedEngine(_ref_config(twin, sv), ref[twin])
    rids = _submit(eng, prompts, new, RRequest, RSampling)
    done = eng.run_until_complete()
    want = [done[r] for r in rids]
    runs_ = _same_on_every_rank(ranks, "two_mesh")
    assert runs_[0]["tokens"] == want
    assert runs_[0]["stats"]["migrated_requests"] == len(prompts)
    for rank, run in zip(ranks, runs_):
        if rank["role"] == "prefill":
            assert run["metrics"]["prefix_shared_tokens"] > 0
            assert run["decode_keys"] == [] and run["prefill_keys"]
            assert run["wire"]["bytes"] > 0
        else:
            assert run["prefill_keys"] == [] and run["decode_keys"]
            assert run["metrics"]["decode_calls"] > 0


@pytest.mark.parametrize("name", ["resumed", "defer_bounce", "retry", "moe"])
def test_router_equals_reference_router(runs, name):
    """Tokens and ``migration_stats()`` (less ``migration_us``) equal the
    JAX ``DisaggRouter``'s at tp=1, on all four ranks."""
    ranks, ref = runs
    want_tokens, want_stats = _ref_router(ref, name)
    runs_ = _same_on_every_rank(ranks, name)
    assert runs_[0]["tokens"] == want_tokens
    assert runs_[0]["stats"] == want_stats, (runs_[0]["stats"], want_stats)
    prefill = [run for rank, run in zip(ranks, runs_)
               if rank["role"] == "prefill"]
    decode = [run for rank, run in zip(ranks, runs_)
              if rank["role"] == "decode"]
    if name == "resumed":
        assert all(run["metrics"]["resumed_grants"] > 0 for run in prefill)
    if name == "defer_bounce":
        st = runs_[0]["stats"]
        assert st["deferrals"] > 0 and st["bounce_backs"] > 0
        assert all(run["metrics"]["preemptions"] == st["bounce_backs"]
                   for run in decode)
    if name == "retry":
        # the forced failure queued the transfer; its retry attached it
        assert all(run["attach_calls"] >= 2 for run in decode)
        assert runs_[0]["stats"]["migrated_requests"] == len(CASES[name][1])
        assert runs_[0]["stats"]["deferrals"] >= 1


def test_quantized_comm_equals_the_mixed_tp2_engine(runs):
    ranks, _ = runs
    runs_ = _same_on_every_rank(ranks, "quantized")
    for run in runs_:
        assert run["tokens"] == run["mixed_tokens"]
    assert runs_[0]["stats"]["migrated_requests"] == 3
