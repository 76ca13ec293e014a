"""The VLM family in the port against the JAX package, fp32 on the CPU, on
the reference's ``tiny_vlm`` twin (8 patches of width 64) with the
reference's weights carried over by the bridge:

  * internvl2-2b's fields and ``param_count`` are the reference's, and no
    registered name is left unported;
  * prefill logits with patches prepended, over 1 and 2 ISO chunks, equal
    ``repro.models.decoder.prefill(extra_embeds=)``;
  * ``PagedEngine`` tokens and counters equal the JAX ``PagedEngine``'s
    under the reference's default features (sharing, packing, bucketing
    and spec_k 2 asked for; the gates keep patch grants whole, unpadded,
    unpacked and unshared), with text-only requests beside patch requests,
    with a preemption, and with the cost model's grant cap cutting a patch
    grant (its tail resumes at a text offset); the dense ``Engine``'s equal
    the JAX ``Engine``'s; paged == dense (the reference's
    ``test_paged_vlm_matches_dense``);
  * ``DisaggRouter`` equals the reference's router on patch requests;
  * tp=2 over gloo equals the reference engine on the same tp-built
    params;
  * the launcher serves ``--arch internvl2-2b`` paged and dense.

The reference's ``api.prefill`` reads ``batch["patches"]`` for every VLM
call, so it raises ``KeyError`` on a text-only request or a resumed grant
(ROADMAP queue C).  Its engines run here with that one lookup made
optional (``batch.get``), in this process only."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_vlm  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.config import get_model_config as r_get  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models import decoder as r_dec  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.disagg import DisaggRouter as RDisaggRouter  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig, get_model_config  # noqa: E402
from repro_torch.configs import UNPORTED, VLM  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import serve_rank  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.disagg import DisaggRouter  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_vlm(vocab_size=64)
PORT_CFG = ModelConfig(**{f.name: getattr(REF_CFG, f.name)
                          for f in dataclasses.fields(ModelConfig)})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
COUNTERS = ("prefill_calls", "prefill_grants", "resumed_grants",
            "prefill_tokens", "decode_calls", "decode_tokens", "preemptions",
            "prefill_pad_tokens", "prefill_pad_rows", "prefix_shared_tokens",
            "cow_copies", "spec_calls", "spec_tokens", "completed")


@pytest.fixture(autouse=True)
def _reference_text_batches(monkeypatch):
    """The reference's ``api.prefill`` with ``batch.get("patches")``."""
    real = r_api.prefill

    def prefill(params, cfg, ctx, iso, batch, **kw):
        if cfg.family == "vlm" and "patches" not in batch:
            return r_dec.prefill(params, cfg, ctx, iso,
                                 tokens=batch["tokens"], **kw)
        return real(params, cfg, ctx, iso, batch, **kw)

    monkeypatch.setattr(r_api, "prefill", prefill)


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, ref)
    return ref, bridge.from_reference(host, device="cpu")


def _traffic(lengths, with_patches, seed, head: int = 0):
    """(prompts, patches or None per request); ``head`` > 0 opens every
    text-only prompt with one shared ``head``-token system prompt."""
    rng = np.random.default_rng(seed)
    system = rng.integers(2, 64, head).astype(np.int32)
    prompts, patches = [], []
    for n, vis in zip(lengths, with_patches):
        p = rng.integers(2, 64, n).astype(np.int32)
        prompts.append(p if vis else np.concatenate([system, p]))
        patches.append((rng.standard_normal((REF_CFG.num_patches,
                                             REF_CFG.d_model)) * 0.1
                        ).astype(np.float32) if vis else None)
    return prompts, patches


def _serve(eng, prompts, patches, new, request=Request,
           sampling=SamplingParams):
    rids = [eng.add_request(request(
        prompt=p.copy(), rid=i, patches=None if x is None else x.copy(),
        sampling=sampling(max_new_tokens=new, eos_id=-1)))
        for i, (p, x) in enumerate(zip(prompts, patches))]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids]


# name -> (serving kwargs, prompt lengths, which carry patches, new
# tokens, grant cap)
CASES = {
    # the reference's defaults (sharing, packing, bucketing) and spec_k 2;
    # two text-only prompts share a 16-token head, and with a 16-token
    # budget they resume across grants
    "defaults": (dict(spec_k=2, page_size=8, max_len=96, max_batch=4,
                      prefill_token_budget=16),
                 (14, 21, 9, 30), (True, False, True, False), 6, None),
    # a pool too small for both: an eviction and a recompute, patches
    # included
    "preempt": (dict(num_pages=9, page_size=8, max_len=64, max_batch=2,
                     prefill_token_budget=64, prefix_sharing=False),
                (20, 24), (True, True), 12, None),
    # a grant cap of 12 cuts the 8 patches + 20 text tokens of a request
    # after 4 text tokens; the tail resumes at text offset 4
    "grant_cap": (dict(page_size=8, max_len=96, max_batch=2,
                       prefill_token_budget=64),
                  (20, 11), (True, False), 5, 12),
}


def _engines(case, weights):
    ref_params, params = weights
    sv, lengths, vis, new, cap = CASES[case]
    ref = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(**sv)),
                       ref_params)
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO, serving=ServingConfig(**sv)),
                      params, device="cpu")
    if cap is not None:
        ref.scheduler._grant_cap = eng.scheduler._grant_cap = cap
    return ref, eng


# ---------------------------------------------------------------------------
# config and model
# ---------------------------------------------------------------------------

def test_internvl2_config_matches_reference():
    assert VLM == ["internvl2-2b"] and UNPORTED == {}
    got, want = get_model_config("internvl2-2b"), r_get("internvl2-2b")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count() == 1_889_144_832


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_prefill_with_patches_matches_reference(weights, n_chunks):
    ref_params, params = weights
    rng = np.random.default_rng(n_chunks)
    tokens = rng.integers(0, 64, (2, 24)).astype(np.int32)
    patches = (rng.standard_normal((2, 8, 64)) * 0.1).astype(np.float32)
    r_iso = iso_cfg(n_chunks, min_chunk_tokens=8, chunk_align=8)
    want = r_dec.prefill(ref_params, REF_CFG, RAxisCtx(), r_iso,
                         tokens=jnp.asarray(tokens),
                         extra_embeds=jnp.asarray(patches),
                         logits_mode="all")
    out = api.prefill(params, PORT_CFG, AxisCtx(),
                      ISOConfig(enabled=True, num_chunks=n_chunks,
                                min_chunk_tokens=8, chunk_align=8),
                      {"tokens": torch.from_numpy(tokens),
                       "patches": torch.from_numpy(patches)},
                      logits_mode="all")
    assert out["num_chunks"] == want["num_chunks"] == n_chunks
    assert out["logits_local"].shape == (2, 32, 2048)
    np.testing.assert_allclose(out["logits_local"].numpy(),
                               np.asarray(want["logits_local"]),
                               rtol=1e-5, atol=1e-5)


def test_make_inputs_split_patches_from_text():
    batch = api.make_inputs(PORT_CFG, 12, 2, seed=1, dtype=torch.float32,
                            device="cpu")
    assert batch["tokens"].shape == (2, 6)
    assert batch["patches"].shape == (2, 6, 64)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_matches_reference(weights, case):
    _, lengths, vis, new, _ = CASES[case]
    prompts, patches = _traffic(lengths, vis, seed=len(case), head=16)
    ref, eng = _engines(case, weights)
    want = _serve(ref, prompts, patches, new, RRequest, RSampling)
    assert _serve(eng, prompts, patches, new) == want
    for k in COUNTERS:
        assert eng.metrics[k] == ref.metrics[k], k
    assert set(eng._prefill_fns) == {k[::2] if k[1] == 0 else k
                                     for k in ref._prefill_fns}
    assert eng.alloc.stats()["free_pages"] == eng.alloc.num_pages
    if case == "defaults":
        assert eng._buckets is None and not eng._batch_prefill
        assert eng.spec_k == 2 and eng.metrics["prefix_shared_tokens"] > 0
        assert eng.metrics["resumed_grants"] > 0
    elif case == "preempt":
        assert eng.metrics["preemptions"] > 0
    else:
        assert any(e.kind == "decision" and e.payload["point"] ==
                   "grant_cap" for e in eng.trace.events())
        # 8 patches + 4 text tokens, then the tail at text offset 4
        assert {(4, 8, False), (12, True), (4, True)} <= \
            set(eng._prefill_fns)


def test_dense_engine_matches_reference_and_paged(weights):
    ref_params, params = weights
    prompts, patches = _traffic((14, 21, 9), (True, False, True), seed=5)
    kw = dict(max_batch=2, max_len=96, bucket=16)
    want = _serve(REngine(RConfig(model=REF_CFG,
                                  parallel=RParallel(data=1, model=1),
                                  iso=REF_ISO), ref_params, mesh=None, **kw),
                  prompts, patches, 6, RRequest, RSampling)
    dense = Engine(Config(model=PORT_CFG,
                          parallel=ParallelConfig(data=1, model=1),
                          iso=PORT_ISO), params, device="cpu", **kw)
    assert _serve(dense, prompts, patches, 6) == want
    assert dense.metrics["prefill_tokens"] == 14 + 21 + 9
    # paged == dense (the reference's test_paged_vlm_matches_dense)
    paged = PagedEngine(Config(model=PORT_CFG,
                               parallel=ParallelConfig(data=1, model=1),
                               iso=PORT_ISO,
                               serving=ServingConfig(page_size=8, max_len=96,
                                                     max_batch=2)),
                        params, device="cpu")
    assert _serve(paged, prompts, patches, 6) == want


def test_disagg_router_matches_reference(weights):
    ref_params, params = weights
    prompts, patches = _traffic((14, 21, 9, 17), (True, True, False, True),
                                seed=7)
    sv = dict(page_size=8, max_len=96, max_batch=2, disagg=True,
              decode_pool_pages=12, prefill_token_budget=32)
    ref = RDisaggRouter(RConfig(model=REF_CFG,
                                parallel=RParallel(data=1, model=1),
                                iso=REF_ISO, serving=RServing(**sv)),
                        ref_params)
    want = _serve(ref, prompts, patches, 5, RRequest, RSampling)
    router = DisaggRouter(Config(model=PORT_CFG,
                                 parallel=ParallelConfig(data=1, model=1),
                                 iso=PORT_ISO, serving=ServingConfig(**sv)),
                          params, prefill_device="cpu", decode_device="cpu")
    assert _serve(router, prompts, patches, 5) == want
    assert router.stats == ref.stats
    assert router.stats["migrated_requests"] == 4


def test_tp2_matches_reference(tmp_path):
    """Two gloo ranks on tp=2-built params; the reference engine (mesh=None)
    on the same whole params gives the tokens."""
    ref = r_api.init_params(jax.random.PRNGKey(1), REF_CFG, tp=2,
                            dtype=jnp.float32)
    path = tmp_path / "params.npz"
    bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
    prompts, patches = _traffic((14, 30, 9), (True, True, False), seed=9)
    sv = dict(page_size=8, max_len=96, max_batch=2, prefill_token_budget=16)
    want = _serve(RPagedEngine(RConfig(model=REF_CFG,
                                       parallel=RParallel(data=1, model=1),
                                       iso=REF_ISO, serving=RServing(**sv)),
                               ref), prompts, patches, 5, RRequest,
                  RSampling)
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=2),
                    iso=PORT_ISO, serving=ServingConfig(**sv))
    variant = dict(prompts=prompts, patches=patches, max_new=5)
    res = mesh.spawn(serve_rank, 2, args=(config, [variant], str(path)),
                     device="cpu", timeout_s=300)
    for rank in res:
        assert rank[0]["tokens"] == want


@pytest.mark.parametrize("paged", [True, False])
def test_launcher_serves_internvl2(capsys, paged):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "internvl2-2b", "--preset", "tiny",
                       "--device", "cpu", "--dtype", "float32",
                       "--requests", "2", "--prompt-len", "40",
                       "--max-new", "3"] + (["--paged"] if paged else [])
                      ) == 0
    out = capsys.readouterr().out
    assert "arch=internvl2-2b" in out and "completed=2" in out
