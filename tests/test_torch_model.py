"""The port's model and engine against the JAX reference on the same weights
(bridged from the reference's ``init_params``), fp32 on the CPU, where the
port's kernel wrappers take their plain versions and the JAX side runs its
Pallas kernels under the interpreter.

Model: prefill logits over 2 ISO chunks, a resumed paged prefill with a
bucket-pad tail, and a paged decode step (logits and the pools it writes),
atol 1e-4.  Engine: greedy tokens EQUAL to the JAX ``PagedEngine`` on mixed,
resumed, split-KV and preemption traffic."""
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

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
PS, NP = 8, 12              # model tests: page size, usable pages

# (name, prompt lengths, rng seed, new tokens, serving kwargs)
CASES = [
    # the mixed-length traffic of tests/test_paged.py:237-262 under its
    # 16-token budget: long prompts resume across grants, so the paged
    # prefill kernel reads page-resident prefixes
    ("mixed_resumed", (70, 12, 33, 7), 3, 5,
     dict(prefill_token_budget=16, page_size=8, max_len=160, max_batch=2)),
    # split-KV decode forced to 4 spans (reduce kernel on every step)
    ("splits4", (70, 12, 33, 7), 3, 5,
     dict(prefill_token_budget=64, page_size=8, max_len=160, max_batch=2,
          decode_kv_splits=4)),
    # tests/test_paged.py:304: a pool of 8 pages forces eviction + recompute
    ("preempt", (40, 40), 6, 8,
     dict(prefill_token_budget=64, page_size=8, max_len=64, max_batch=2,
          num_pages=8)),
]


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, ref)
    return ref, bridge.from_reference(host, device="cpu")


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               atol=1e-4, rtol=1e-4)


def _pools(rng):
    shape = (REF_CFG.num_layers, NP + 1, PS, REF_CFG.num_kv_heads,
             REF_CFG.resolved_head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def test_prefill_logits_match_iso_chunks(weights):
    ref, params = weights
    toks = np.random.default_rng(0).integers(0, 64, (2, 24)).astype(np.int32)
    want = r_dec.prefill(ref, REF_CFG, RAxisCtx(), REF_ISO,
                         tokens=jnp.asarray(toks))
    got = decoder.prefill(params, PORT_CFG, AxisCtx(), PORT_ISO,
                          tokens=torch.from_numpy(toks), return_extras=True)
    assert got["num_chunks"] == want["num_chunks"] == 2
    _close(got["logits_local"], want["logits_local"])
    # the per-position KV the engine scatters, stacked over periods
    assert got["extras"][0]["kv_k"].shape == (2, 2, 24, 2, 16)


def test_resumed_paged_prefill_logits_match(weights):
    """A 16-token grant (13 real, 3 bucket pad) resuming at position 21 over
    a page-resident prefix: the paged prefill kernel's path."""
    ref, params = weights
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng)
    bt = np.asarray([[5, 2, 9, 0, -1, -1]], np.int32)
    toks = rng.integers(0, 64, (1, 16)).astype(np.int32)
    kw = dict(pos_offset=21, valid_len=13)
    want = r_dec.prefill(
        ref, REF_CFG, RAxisCtx(), REF_ISO, tokens=jnp.asarray(toks),
        prefix_caches=({"k_pages": jnp.asarray(kp),
                        "v_pages": jnp.asarray(vp)},),
        block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray([21], jnp.int32), **kw)
    got = decoder.prefill(
        params, PORT_CFG, AxisCtx(), PORT_ISO, tokens=torch.from_numpy(toks),
        prefix_caches=({"k_pages": torch.from_numpy(kp),
                        "v_pages": torch.from_numpy(vp)},),
        block_tables=torch.from_numpy(bt),
        prefix_lens=torch.tensor([21], dtype=torch.int32), **kw)
    assert got["num_chunks"] == 2
    _close(got["logits_local"][:, :13], want["logits_local"][:, :13])


def test_paged_decode_step_matches(weights):
    """Batched decode over block tables (one inactive slot), split-KV S=4 in
    the reference against S=1 and S=4 in the port; logits and the pools'
    in-place update both match."""
    ref, params = weights
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    bt = np.asarray([[3, 7, 1, -1], [4, 10, -1, -1], [-1, -1, -1, -1]],
                    np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    mask = np.asarray([True, True, False])
    toks = rng.integers(0, 64, (3, 1)).astype(np.int32)
    want, caches = r_dec.decode_step(
        ref, REF_CFG, RAxisCtx(), jnp.asarray(toks),
        ({"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},),
        jnp.asarray(lens), block_tables=jnp.asarray(bt),
        decode_mask=jnp.asarray(mask), kv_splits=4)
    for S in (1, 4):
        pools = {"k_pages": torch.from_numpy(kp.copy()),
                 "v_pages": torch.from_numpy(vp.copy())}
        got, _ = decoder.decode_step(
            params, PORT_CFG, AxisCtx(), torch.from_numpy(toks), (pools,),
            torch.from_numpy(lens), block_tables=torch.from_numpy(bt),
            decode_mask=torch.from_numpy(mask), kv_splits=S)
        _close(got[:2], want[:2])
        # live pages take the new token's KV in place; the scratch page
        # (index NP) takes the inactive slot's and is never read
        for name in ("k_pages", "v_pages"):
            _close(pools[name][:, :NP], caches[0][name][:, :NP])


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


def _run_reference(ref_params, prompts, new, sv):
    config = RConfig(model=REF_CFG, parallel=RParallel(data=1, model=1),
                     iso=REF_ISO,
                     serving=RServing(prefix_sharing=False,
                                      prefill_batching=False, **sv))
    eng = RPagedEngine(config, ref_params)
    rids = [eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids], eng.metrics


def _run_port(params, prompts, new, sv):
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=1),
                    iso=PORT_ISO,
                    serving=ServingConfig(prefix_sharing=False,
                                          prefill_batching=False, **sv))
    eng = PagedEngine(config, params, device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("name,lengths,seed,new,sv", CASES,
                         ids=[c[0] for c in CASES])
def test_engine_tokens_equal_reference(weights, name, lengths, seed, new, sv):
    ref_params, params = weights
    prompts = _prompts(lengths, seed)
    ref_out, ref_m = _run_reference(ref_params, prompts, new, sv)
    out, eng = _run_port(params, prompts, new, sv)
    assert out == ref_out
    m = eng.metrics
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "preemptions", "prefill_pad_tokens"):
        assert m[k] == ref_m[k], (k, m[k], ref_m[k])
    assert m["completed"] == len(prompts)
    assert eng.alloc.free_pages == eng.alloc.num_pages    # no page leaked
    eng.alloc.check()
    if name == "mixed_resumed":
        assert m["resumed_grants"] > 0
    if name == "preempt":
        assert m["preemptions"] > 0
