"""The port's engines on an MoE stack against the JAX package's, fp32 on the
CPU on bridged weights of two ``tiny_moe`` twins: ``tiny`` (capacity factor
8.0: nothing drops) and ``drop`` (1.25, where the capacity drops
assignments in the run, counted on the port's side).  An MoE model's output
depends on how its tokens are batched whenever an assignment drops (the
capacity is taken from each call's own token count), so every comparison
here runs both packages under the same settings:

  * ``PagedEngine``: batch-1 resumed grants; the reference's defaults
    (packed grants, prefix sharing) with a spec_k=2 verify window; split-KV
    decode forced to 4 spans.  Tokens and counters equal, no page leaked;
  * the dense-cache ``Engine``, plain and with spec_k=2: tokens and
    counters equal;
  * ``DisaggRouter``: tokens and migration stats equal, and equal to the
    single engine's on the twin where nothing drops."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_moe  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import MoEConfig as RMoEConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.disagg import DisaggRouter as RDisaggRouter  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, MoEConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.disagg import DisaggRouter  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

TWINS = {
    "tiny": tiny_moe(vocab_size=64),
    "drop": tiny_moe(vocab_size=64, moe=RMoEConfig(
        num_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.25,
        shared_expert_d_ff=32)),
}
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
COUNTERS = ("prefill_calls", "prefill_grants", "resumed_grants",
            "decode_calls", "preemptions", "prefill_pad_tokens",
            "prefill_pad_rows", "prefix_shared_tokens", "cow_copies",
            "spec_calls", "spec_tokens")


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return ModelConfig(**kw)


_WEIGHTS = {}


@pytest.fixture(params=sorted(TWINS))
def twin(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    name = request.param
    if name not in _WEIGHTS:
        ref = r_api.init_params(jax.random.PRNGKey(0), TWINS[name], tp=1,
                                dtype=jnp.float32)
        _WEIGHTS[name] = (ref, bridge.from_reference(
            jax.tree_util.tree_map(np.asarray, ref), device="cpu"))
    return (name, TWINS[name], port_cfg(TWINS[name])) + _WEIGHTS[name]


@pytest.fixture
def drops(monkeypatch):
    """Count the assignments the port's MoE layers drop (tp=1)."""
    count = [0]
    real = moe.route

    def route(router_w, x, mcfg, e_pad):
        w, idx, aux = real(router_w, x, mcfg, e_pad)
        C = moe.capacity(x.shape[0], mcfg, e_pad)
        load = torch.bincount(idx.reshape(-1), minlength=e_pad)
        count[0] += int(torch.clamp_min(load - C, 0).sum())
        return w, idx, aux

    monkeypatch.setattr(moe, "route", route)
    return count


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


def _feature_prompts():
    """Repetitive (draft-friendly), two with a shared 24-token head, one
    random."""
    rng = np.random.default_rng(5)
    head = rng.integers(2, 64, 24).astype(np.int32)
    rep = np.tile(rng.integers(2, 64, 6).astype(np.int32), 6)[:33]
    return [rep, np.concatenate([head, rng.integers(2, 64, 9)]).astype(
        np.int32), np.concatenate([head, rng.integers(2, 64, 4)]).astype(
        np.int32), rng.integers(2, 64, 17).astype(np.int32)]


# name -> (prompts, new tokens, serving overrides)
SETTINGS = {
    "batch1_resumed": (_prompts((70, 12, 33, 7), 3), 5,
                       dict(prefill_token_budget=16, page_size=8, max_len=160,
                            max_batch=2, prefix_sharing=False,
                            prefill_batching=False)),
    "defaults_spec2": (_feature_prompts(), 8,
                       dict(prefill_token_budget=64, page_size=8, max_len=160,
                            max_batch=4, spec_k=2)),
    "splits4": (_prompts((70, 12, 33, 7), 3), 5,
                dict(prefill_token_budget=64, page_size=8, max_len=160,
                     max_batch=2, decode_kv_splits=4)),
}


def _serve(eng, prompts, new, make_req, make_sp):
    rids = [eng.add_request(make_req(prompt=p.copy(), sampling=make_sp(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_paged_engine_equals_reference(twin, setting, drops):
    name, rcfg, pcfg, ref_params, params = twin
    prompts, new, sv = SETTINGS[setting]
    r_eng = RPagedEngine(RConfig(model=rcfg, parallel=RParallel(data=1,
                                                                model=1),
                                 iso=REF_ISO, serving=RServing(**sv)),
                         ref_params)
    want = _serve(r_eng, prompts, new, RRequest, RSampling)
    eng = PagedEngine(Config(model=pcfg, parallel=ParallelConfig(data=1,
                                                                 model=1),
                             iso=PORT_ISO, serving=ServingConfig(**sv)),
                      params, device="cpu")
    got = _serve(eng, prompts, new, Request, SamplingParams)
    assert got == want
    for k in COUNTERS:
        assert eng.metrics[k] == r_eng.metrics[k], (k, eng.metrics[k],
                                                     r_eng.metrics[k])
    assert eng.alloc.free_pages == eng.alloc.num_pages
    eng.alloc.check()
    assert (drops[0] > 0) == (name == "drop"), drops[0]
    if setting == "defaults_spec2":
        m = eng.metrics
        assert m["prefix_shared_tokens"] > 0 and m["spec_calls"] > 0
        assert m["prefill_calls"] < m["prefill_grants"]
    if setting == "splits4":
        assert set(eng.decode_splits) == {4}


@pytest.mark.parametrize("spec_k", [0, 2])
def test_dense_engine_equals_reference(twin, spec_k, drops):
    name, rcfg, pcfg, ref_params, params = twin
    prompts = _feature_prompts()
    kw = dict(max_batch=2, max_len=128, bucket=16, spec_k=spec_k)
    r_eng = REngine(RConfig(model=rcfg, parallel=RParallel(data=1, model=1),
                            iso=REF_ISO), ref_params, mesh=None, **kw)
    want = _serve(r_eng, prompts, 8, RRequest, RSampling)
    eng = Engine(Config(model=pcfg, parallel=ParallelConfig(data=1, model=1),
                        iso=PORT_ISO), params, device="cpu", **kw)
    got = _serve(eng, prompts, 8, Request, SamplingParams)
    assert got == want
    for k in eng.metrics:
        if not k.endswith("_s") and k != "ttft_sum":
            assert eng.metrics[k] == r_eng.metrics[k], k
    assert eng.spec_k == spec_k
    if spec_k:
        assert eng.metrics["spec_calls"] > 0
    assert (drops[0] > 0) == (name == "drop"), drops[0]


def test_disagg_router_equals_reference(twin):
    name, rcfg, pcfg, ref_params, params = twin
    prompts = _feature_prompts()
    sv = dict(page_size=8, max_batch=2, max_len=160, prefill_token_budget=16,
              disagg=True, spec_k=2)
    r_router = RDisaggRouter(RConfig(model=rcfg,
                                     parallel=RParallel(data=1, model=1),
                                     iso=REF_ISO, serving=RServing(**sv)),
                             ref_params)
    want = _serve(r_router, prompts, 8, RRequest, RSampling)
    config = Config(model=pcfg, parallel=ParallelConfig(data=1, model=1),
                    iso=PORT_ISO, serving=ServingConfig(**sv))
    router = DisaggRouter(config, params, prefill_device="cpu")
    got = _serve(router, prompts, 8, Request, SamplingParams)
    assert got == want
    ms, rms = router.migration_stats(), r_router.migration_stats()
    ms.pop("migration_us")
    rms.pop("migration_us")
    assert ms == rms and router.stats["migrated_requests"] == 4
    for eng in (router.prefill, router.decode):
        assert eng.alloc.used_pages == 0
        eng.alloc.check()
    a, b = router.prefill.params, router.decode.params
    assert a["periods"][0][0]["moe"]["w_up"].data_ptr() == \
        b["periods"][0][0]["moe"]["w_up"].data_ptr()
    if name == "tiny":
        # nothing drops, so the router's batching cannot change a token
        single = PagedEngine(dataclasses.replace(
            config, serving=ServingConfig(**dict(sv, disagg=False))), params,
            device="cpu")
        assert _serve(single, prompts, 8, Request, SamplingParams) == got
