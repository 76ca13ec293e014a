"""The ladder-residual twins in the port (``config.ladder_variant``,
``configs/ladder.py``, ``core/iso.run_layer(ladder=True)`` and
``run_stack_decode_ladder``) against the JAX reference, fp32 on the CPU on
bridged weights, after tests/test_ladder.py.

A ladder config is a different model function from its base, so the bar is
deferred == immediate collectives of the SAME ladder function, and port ==
JAX, never ladder == standard:

  * the three ladder configs equal the reference's field for field, and
    their weights have the base layout (``bridge`` carries them unchanged);
  * prefill runs single-chunk whatever the ISO config (bit-equal to an
    unchunked call) and equals the JAX ladder prefill;
  * ``decode_step`` under ``ladder`` and ``ladder_seq`` is bit-equal on the
    paged pools at K = 1 and a K = 3 window;
  * the engine (``decode_overlap`` True -> ``ladder``, False ->
    ``ladder_seq``) under prefix sharing, forced preemption-recompute, B = 1
    and a spec_k = 2 window gives the JAX ladder engine's tokens;
  * at tp = 2 and tp = 4 over gloo ranks (``launch/mesh.spawn``), deferred
    and immediate ladder decode with sharing, spec_k = 2 and a pool tight
    enough to preempt give the JAX tp=1 ladder engine's tokens.

  * the dense ``Engine`` on a ladder config (immediate collectives on its
    default schedule) gives the paged ladder engine's tokens, and the JAX
    dense engine's (the reference's ``test_ladder_paged_equals_dense_engine``)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_xlstm  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ISOConfig as RISO  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.config import get_model_config as r_get  # noqa: E402
from repro.config import ladder_variant as r_ladder_variant  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig, get_model_config, \
    ladder_variant  # noqa: E402
from repro_torch.configs import LADDER  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import serve_rank  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = r_ladder_variant(tiny_dense(vocab_size=64))
PORT_BASE = ModelConfig(**{f: getattr(tiny_dense(vocab_size=64), f)
                           for f in ("name", "family", "num_layers",
                                     "d_model", "num_heads", "num_kv_heads",
                                     "d_ff", "vocab_size", "qk_norm")})
PORT_CFG = ladder_variant(PORT_BASE)
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


# ---------------------------------------------------------------------------
# config surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LADDER)
def test_ladder_config_equals_reference(name):
    got, want = get_model_config(name), r_get(name)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.residual_wiring == "ladder"
    twin = get_model_config(name[len("ladder-"):])
    assert twin.residual_wiring == "standard"
    assert dataclasses.replace(got, name=twin.name,
                               residual_wiring="standard") == twin


def test_ladder_variant_guards():
    assert PORT_CFG.residual_wiring == "ladder"
    assert PORT_CFG.name == "ladder-t-dense" == REF_CFG.name
    with pytest.raises(AssertionError):
        ladder_variant(PORT_CFG)                 # already ladder-wired
    xl = tiny_xlstm()
    with pytest.raises(AssertionError):
        ladder_variant(ModelConfig(**{f.name: getattr(xl, f.name) for f in
                                      dataclasses.fields(ModelConfig)}))


def test_ladder_params_bridge_unchanged(weights):
    """A ladder twin's weights have its base config's layout: the port
    makes the same weights for both from one seed, and the bridge carries
    the reference's ladder weights over and back unchanged."""
    ref, _ = weights
    host = jax.tree_util.tree_map(np.asarray, ref)
    back = bridge.to_reference(bridge.from_reference(host, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    lad = api.init_params(3, PORT_CFG, dtype=torch.float32, device="cpu")
    std = api.init_params(3, PORT_BASE, dtype=torch.float32, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(bridge.to_reference(lad)),
                    jax.tree_util.tree_leaves(bridge.to_reference(std))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# model-function level
# ---------------------------------------------------------------------------

def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(2, 64, shape).astype(np.int32)


def test_ladder_prefill_single_chunk_equals_reference(weights):
    """ISO chunking would restore the standard wiring per chunk, so ladder
    prefill runs one chunk whatever the ISO config: a chunked call is
    bit-equal to an unchunked one, and equals the JAX ladder prefill."""
    ref, params = weights
    toks = _tokens(1, (2, 24))
    chunked = api.prefill(params, PORT_CFG, AxisCtx(),
                          ISOConfig(enabled=True, num_chunks=4,
                                    min_chunk_tokens=2, chunk_align=4),
                          {"tokens": torch.from_numpy(toks)})
    plain = api.prefill(params, PORT_CFG, AxisCtx(), ISOConfig(enabled=False),
                        {"tokens": torch.from_numpy(toks)})
    assert chunked["num_chunks"] == 1
    assert torch.equal(chunked["logits_local"], plain["logits_local"])
    want = r_api.prefill(ref, REF_CFG, RAxisCtx(), RISO(enabled=False),
                         {"tokens": jnp.asarray(toks)})["logits_local"]
    np.testing.assert_allclose(plain["logits_local"].numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ladder_differs_from_standard_function(weights):
    """The ladder twin is a different function: the differentials above
    would pass trivially if the rewiring were a no-op."""
    _, params = weights
    toks = torch.from_numpy(_tokens(2, (1, 16)))
    o_std = api.prefill(params, PORT_BASE, AxisCtx(), ISOConfig(enabled=False),
                        {"tokens": toks})
    o_lad = api.prefill(params, PORT_CFG, AxisCtx(), ISOConfig(enabled=False),
                        {"tokens": toks})
    assert not torch.allclose(o_std["logits_local"], o_lad["logits_local"])


@pytest.mark.parametrize("K", [1, 3])
def test_ladder_decode_defer_equals_immediate_stack(weights, K):
    """``decode_step`` under ``ladder`` (deferred) and ``ladder_seq``
    (immediate): bit-equal logits and page pools, on pools prefilled with
    the same KV."""
    _, params = weights
    out = []
    for schedule in ("ladder", "ladder_seq"):
        kv = PagedKVCache(PORT_CFG, num_pages=8, page_size=8,
                          dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for t in kv.k + kv.v:
            t.copy_(torch.randn(t.shape, generator=gen))
        caches = ({"k_pages": kv.k[0], "v_pages": kv.v[0]},)
        bt = torch.tensor([[0, 1, -1], [2, 3, 4]], dtype=torch.int32)
        lens = torch.tensor([4, 17], dtype=torch.int32)
        toks = torch.arange(2 * K, dtype=torch.int32).reshape(2, K) + 2
        logits, _ = api.decode_step(params, PORT_CFG, AxisCtx(), toks,
                                    caches, lens, block_tables=bt,
                                    decode_mask=torch.ones(2, dtype=bool),
                                    schedule=schedule)
        out.append((logits, kv.k[0].clone(), kv.v[0].clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine level (tp=1, fp32)
# ---------------------------------------------------------------------------

def _sv(**kw):
    base = dict(page_size=8, max_batch=3, max_len=96,
                prefill_token_budget=48)
    base.update(kw)
    return base


def _port(params, prompts, max_new=8, **sv):
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO, serving=ServingConfig(**_sv(**sv))),
                      params, device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=max_new, eos_id=-1))) for p in prompts]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def _ref(ref_params, prompts, max_new=8, **sv):
    eng = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=REF_ISO, serving=RServing(**_sv(**sv))),
                       ref_params, mesh=None)
    rids = [eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=max_new, eos_id=-1))) for p in prompts]
    outs = eng.run_until_complete()
    return [outs[r] for r in rids], eng


def _system_prompts(seed, lengths, lo=2, hi=64):
    rng = np.random.default_rng(seed)
    system = rng.integers(2, 64, 16).astype(np.int32)
    return [np.concatenate([system, rng.integers(lo, hi, n).astype(np.int32)])
            for n in lengths]


def test_ladder_engine_defer_equals_immediate_mixed_traffic(weights):
    """Deferred (``decode_overlap``) vs immediate ladder collectives under
    prefix sharing and a pool tight enough to force preemption-recompute,
    and a roomy pool: the same tokens, the JAX ladder engine's.  A
    recomputed prompt replays through prefill and decode resumes, so this
    also holds ladder prefill and ladder decode to one function."""
    ref_params, params = weights
    prompts = _system_prompts(11, (20, 6, 13))
    kw = dict(max_batch=2, max_len=64, prefill_token_budget=32)
    t_defer, e_defer = _port(params, prompts, num_pages=7, **kw)
    t_imm, e_imm = _port(params, prompts, num_pages=7, decode_overlap=False,
                         **kw)
    t_roomy, e_roomy = _port(params, prompts, **kw)
    t_ref, e_ref = _ref(ref_params, prompts, num_pages=7, **kw)
    assert e_defer._decode_schedule == "ladder"
    assert e_imm._decode_schedule == "ladder_seq"
    assert e_defer.metrics["preemptions"] > 0
    assert e_roomy.metrics["preemptions"] == 0
    assert e_defer.metrics["prefix_shared_tokens"] > 0
    assert t_defer == t_imm == t_roomy == t_ref
    for name in ("preemptions", "prefix_shared_tokens", "prefill_calls",
                 "decode_calls"):
        assert e_defer.metrics[name] == e_ref.metrics[name], name


def test_ladder_engine_schedule_choice(weights):
    """``decode_schedule`` may name ``ladder``/``ladder_seq`` on a ladder
    config; on a standard config it raises (it would serve the rewired
    function)."""
    _, params = weights
    prompt = [np.arange(2, 20, dtype=np.int32)]
    a, ea = _port(params, prompt, decode_schedule="ladder_seq")
    b, eb = _port(params, prompt, decode_schedule="cross_block")
    assert (ea._decode_schedule, eb._decode_schedule) == \
        ("ladder_seq", "ladder")
    assert a == b
    with pytest.raises(ValueError, match="ladder-wired"):
        PagedEngine(Config(model=PORT_BASE,
                           parallel=ParallelConfig(data=1, model=1),
                           iso=PORT_ISO,
                           serving=ServingConfig(decode_schedule="ladder")),
                    params, device="cpu")


def test_ladder_paged_equals_dense_engine(weights):
    """Paged ladder serving (deferred) vs the dense Engine on the same
    ladder config (immediate collectives through the default sequential
    schedule): the same tokens at fp32, the JAX dense engine's."""
    ref_params, params = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 64, n).astype(np.int32) for n in (18, 7, 25)]
    dense = Engine(Config(model=PORT_CFG,
                          parallel=ParallelConfig(data=1, model=1),
                          iso=PORT_ISO), params, max_batch=2, max_len=96,
                   bucket=16, device="cpu")
    r_dense = REngine(RConfig(model=REF_CFG,
                              parallel=RParallel(data=1, model=1),
                              iso=REF_ISO), ref_params, mesh=None,
                      max_batch=2, max_len=96, bucket=16)
    toks = []
    for eng, request, sampling in ((dense, Request, SamplingParams),
                                   (r_dense, RRequest, RSampling)):
        rids = [eng.add_request(request(prompt=p.copy(), sampling=sampling(
            max_new_tokens=6, eos_id=-1))) for p in prompts]
        outs = eng.run_until_complete()
        toks.append([outs[r] for r in rids])
    paged, e_paged = _port(params, prompts, max_new=6, max_batch=2)
    assert e_paged._decode_schedule == "ladder"
    assert toks[0] == paged == toks[1]


def test_ladder_engine_single_request_b1(weights):
    """Ladder needs no second batch half: max_batch=1 serves, deferred ==
    immediate == JAX."""
    ref_params, params = weights
    prompt = [np.random.default_rng(9).integers(2, 64, 14).astype(np.int32)]
    t1, _ = _port(params, prompt, max_new=10, max_batch=1)
    t2, _ = _port(params, prompt, max_new=10, max_batch=1,
                  decode_overlap=False)
    t3, _ = _ref(ref_params, prompt, max_new=10, max_batch=1)
    assert t1 == t2 == t3 and len(t1[0]) == 10


def test_ladder_engine_speculative_twin(weights):
    """spec_k=2 verify windows ride the ladder decode stack (K=3 decode calls);
    deferred and immediate accept identical windows, the JAX engine's."""
    ref_params, params = weights
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 8, 20).astype(np.int32) for _ in range(2)]
    t_d, e_d = _port(params, prompts, max_new=10, max_batch=2, spec_k=2)
    t_i, _ = _port(params, prompts, max_new=10, max_batch=2, spec_k=2,
                   decode_overlap=False)
    t_r, e_r = _ref(ref_params, prompts, max_new=10, max_batch=2, spec_k=2)
    assert t_d == t_i == t_r
    assert e_d.metrics["spec_calls"] == e_r.metrics["spec_calls"] > 0
    assert (3, 1) in e_d._decode_fns           # K = spec_k + 1 closure


# ---------------------------------------------------------------------------
# tp = 2 and tp = 4 over gloo ranks
# ---------------------------------------------------------------------------

TP_PROMPTS = _system_prompts(3, (30, 9, 17), lo=2, hi=8)
TP_SV = dict(page_size=8, max_batch=2, max_len=96, prefill_token_budget=32,
             spec_k=2)
# (label, serving overrides): a pool of 8 pages forces preemption
TP_VARIANTS = (("defer", dict(num_pages=8, decode_overlap=True)),
               ("immediate", dict(num_pages=8, decode_overlap=False)),
               ("defer roomy", dict(decode_overlap=True)))


@pytest.fixture(scope="module")
def ref_tp_tokens(weights):
    """The JAX ladder engine at tp=1 on the tight pool."""
    toks, eng = _ref(weights[0], TP_PROMPTS, **dict(TP_SV, num_pages=8))
    assert eng.metrics["preemptions"] > 0
    assert eng.metrics["spec_calls"] > 0
    return toks


@pytest.mark.parametrize("tp", [2, 4])
def test_ladder_tp_defer_equals_immediate_equals_reference(tp, tmp_path,
                                                           ref_tp_tokens):
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=tp,
                            dtype=jnp.float32)
    path = tmp_path / "params.npz"
    bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=tp),
                    iso=PORT_ISO, serving=ServingConfig(**TP_SV))
    variants = [dict(prompts=TP_PROMPTS, max_new=8, serving=sv)
                for _, sv in TP_VARIANTS]
    ranks = mesh.spawn(serve_rank, tp, args=(config, variants, str(path)),
                       device="cpu", timeout_s=300)
    for r, runs in enumerate(ranks):
        for (label, _), run in zip(TP_VARIANTS, runs):
            assert run["tokens"] == ref_tp_tokens, (tp, r, label)
            want = "ladder_seq" if label == "immediate" else "ladder"
            assert run["decode_schedule"] == want
            assert run["schedule_steps"] == {want: run["metrics"][
                "decode_calls"]}
    tight = ranks[0][0]["metrics"]
    assert tight["preemptions"] > 0 and tight["spec_calls"] > 0
    assert tight["prefix_shared_tokens"] > 0
    assert ranks[0][2]["metrics"]["preemptions"] == 0
