"""The head layouts of the registered dense configs, on tiny twins that keep
each config's group, ``qk_norm`` and ``rope_theta``: the port's model and
engine against the JAX reference on bridged fp32 weights, on the CPU (the
port's kernel wrappers take their plain versions, the JAX side runs its
Pallas kernels under the interpreter, as in tests/test_torch_model.py).

Twins: MHA 4/4 with qk_norm off and rope 1e4 (paper-30b, codeqwen1.5-7b,
``head_dim=0`` resolving to d_model / H), MHA 13/13 (paper-30b's tp=4 rank:
a head count that is no power of two) and GQA 8/1 (the group of 8 of
qwen3-32b and paper-70b, with qwen3-32b's head_dim decoupled from
d_model / H).  Per twin: prefill logits over 2 ISO chunks, a resumed paged
prefill, a paged decode step at K 1 and 5 (atol 1e-4); greedy engine tokens
and counters equal to the JAX engine's on mixed traffic with resumed
grants."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models import decoder as r_dec  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

TWINS = {
    "mha4_noqk_rope1e4": tiny_dense(num_heads=4, num_kv_heads=4,
                                    qk_norm=False, rope_theta=1e4,
                                    vocab_size=64),
    "mha13": tiny_dense(d_model=104, num_heads=13, num_kv_heads=13,
                        qk_norm=False, rope_theta=1e4, vocab_size=64),
    "gqa8": tiny_dense(num_heads=8, num_kv_heads=1, head_dim=16,
                       vocab_size=64),
}
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
PS, NP = 8, 12              # model tests: page size, usable pages
MIXED = ((70, 12, 33, 7), 3, 5,
         dict(prefill_token_budget=16, page_size=8, max_len=160, max_batch=2))


def port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


_WEIGHTS = {}


@pytest.fixture(params=sorted(TWINS))
def twin(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    name = request.param
    if name not in _WEIGHTS:
        cfg = TWINS[name]
        ref = r_api.init_params(jax.random.PRNGKey(0), cfg, tp=1,
                                dtype=jnp.float32)
        host = jax.tree_util.tree_map(np.asarray, ref)
        _WEIGHTS[name] = (ref, bridge.from_reference(host, device="cpu"))
    return (name, TWINS[name], port_cfg(TWINS[name])) + _WEIGHTS[name]


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               atol=1e-4, rtol=1e-4)


def _pools(cfg, rng):
    shape = (cfg.num_layers, NP + 1, PS, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def test_twin_params_match_layout(twin):
    """The bridged leaves carry the twin's layout: no q_norm/k_norm without
    qk_norm, every head slot of an unpadded tp=1 layout."""
    name, cfg, _, _, params = twin
    attn = params["periods"][0][0]["attn"]
    assert ("q_norm" in attn) == cfg.qk_norm
    hd = cfg.resolved_head_dim
    assert attn["wq"].shape == (cfg.d_model, cfg.num_heads, hd)
    assert attn["wk"].shape == (cfg.d_model, cfg.num_kv_heads, hd)


def test_prefill_logits_match_iso_chunks(twin):
    _, rcfg, pcfg, ref, params = twin
    toks = np.random.default_rng(0).integers(0, 64, (2, 24)).astype(np.int32)
    want = r_dec.prefill(ref, rcfg, RAxisCtx(), REF_ISO,
                         tokens=jnp.asarray(toks))
    got = decoder.prefill(params, pcfg, AxisCtx(), PORT_ISO,
                          tokens=torch.from_numpy(toks))
    assert got["num_chunks"] == want["num_chunks"] == 2
    _close(got["logits_local"], want["logits_local"])


def test_resumed_paged_prefill_logits_match(twin):
    """A 16-token grant (13 real, 3 bucket pad) resuming at position 21 over
    a page-resident prefix."""
    _, rcfg, pcfg, ref, params = twin
    rng = np.random.default_rng(1)
    kp, vp = _pools(rcfg, rng)
    bt = np.asarray([[5, 2, 9, 0, -1, -1]], np.int32)
    toks = rng.integers(0, 64, (1, 16)).astype(np.int32)
    kw = dict(pos_offset=21, valid_len=13)
    want = r_dec.prefill(
        ref, rcfg, RAxisCtx(), REF_ISO, tokens=jnp.asarray(toks),
        prefix_caches=({"k_pages": jnp.asarray(kp),
                        "v_pages": jnp.asarray(vp)},),
        block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray([21], jnp.int32), **kw)
    got = decoder.prefill(
        params, pcfg, AxisCtx(), PORT_ISO, tokens=torch.from_numpy(toks),
        prefix_caches=({"k_pages": torch.from_numpy(kp),
                        "v_pages": torch.from_numpy(vp)},),
        block_tables=torch.from_numpy(bt),
        prefix_lens=torch.tensor([21], dtype=torch.int32), **kw)
    assert got["num_chunks"] == 2
    _close(got["logits_local"][:, :13], want["logits_local"][:, :13])


@pytest.mark.parametrize("K", [1, 5])
def test_paged_decode_step_matches(twin, K):
    """Batched decode over block tables (one inactive slot), a plain step
    and a 5-token verify window; split-KV S=4 in the reference against S=1
    and S=4 in the port; logits and the pools' in-place update match."""
    _, rcfg, pcfg, ref, params = twin
    rng = np.random.default_rng(2)
    kp, vp = _pools(rcfg, rng)
    bt = np.asarray([[3, 7, 1, 6], [4, 10, -1, -1], [-1, -1, -1, -1]],
                    np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    mask = np.asarray([True, True, False])
    toks = rng.integers(0, 64, (3, K)).astype(np.int32)
    want, caches = r_dec.decode_step(
        ref, rcfg, RAxisCtx(), jnp.asarray(toks),
        ({"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},),
        jnp.asarray(lens), block_tables=jnp.asarray(bt),
        decode_mask=jnp.asarray(mask), kv_splits=4)
    for S in (1, 4):
        pools = {"k_pages": torch.from_numpy(kp.copy()),
                 "v_pages": torch.from_numpy(vp.copy())}
        got, _ = decoder.decode_step(
            params, pcfg, AxisCtx(), torch.from_numpy(toks), (pools,),
            torch.from_numpy(lens), block_tables=torch.from_numpy(bt),
            decode_mask=torch.from_numpy(mask), kv_splits=S)
        assert got.shape[:2] == (3, K)
        _close(got[:2], want[:2])
        for name in ("k_pages", "v_pages"):
            _close(pools[name][:, :NP], caches[0][name][:, :NP])


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


def run_reference(cfg, ref_params, prompts, new, sv, iso=REF_ISO):
    config = RConfig(model=cfg, parallel=RParallel(data=1, model=1), iso=iso,
                     serving=RServing(prefix_sharing=False,
                                      prefill_batching=False, **sv))
    eng = RPagedEngine(config, ref_params)
    rids = [eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids], eng.metrics


def run_port(cfg, params, prompts, new, sv, iso=PORT_ISO):
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=iso,
                    serving=ServingConfig(prefix_sharing=False,
                                          prefill_batching=False, **sv))
    eng = PagedEngine(config, params, device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids], eng


def test_engine_tokens_equal_reference(twin):
    _, rcfg, pcfg, ref_params, params = twin
    lengths, seed, new, sv = MIXED
    prompts = _prompts(lengths, seed)
    ref_out, ref_m = run_reference(rcfg, ref_params, prompts, new, sv)
    out, eng = run_port(pcfg, params, prompts, new, sv)
    assert out == ref_out
    m = eng.metrics
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "preemptions", "prefill_pad_tokens"):
        assert m[k] == ref_m[k], (k, m[k], ref_m[k])
    assert m["completed"] == len(prompts) and m["resumed_grants"] > 0
    assert eng.alloc.free_pages == eng.alloc.num_pages
    eng.alloc.check()
