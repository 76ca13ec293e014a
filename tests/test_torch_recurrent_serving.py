"""The port's engines on the recurrent families against the JAX package's,
fp32 on the CPU on one set of weights (the port's, from a seed, carried to
the reference by the bridge) of the reference's tiny twins:
``tiny_hybrid`` (hymba's ``hybrid`` block, window 16) and ``tiny_xlstm``
(3 mLSTM : 1 sLSTM):

  * ``PagedEngine`` == the JAX ``PagedEngine``: greedy tokens and counters
    equal, on prompts past the window with resumed grants, with one
    preemption (a small pool), and under the reference's default settings
    (sharing, packing, bucketing, spec_k 2 asked for), which the gates turn
    off for a recurrent stack: no prefix cache, spec_k 0, no buckets, one
    call a grant, no pad; every page free after each run;
  * the dense ``Engine`` == the JAX ``Engine`` (its bucket pad advances the
    state in both);
  * paged == dense on prompt lengths that are multiples of the dense
    engine's bucket (16), where the dense engine pads nothing;
  * no closure body of a recurrent engine reads a tensor back to the host
    (the recurrent stages run inside the CUDA graphs);
  * ``DisaggRouter`` refuses a recurrent stack, as the reference does.

Tensor parallelism over gloo is in tests/test_torch_tp.py."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_hybrid, tiny_xlstm  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.disagg import DisaggRouter as RDisaggRouter  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402
from test_torch_moe import _NoHostReads  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, SSMConfig, ServingConfig  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.disagg import DisaggRouter  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

TWINS = {"hybrid": tiny_hybrid(vocab_size=64),
         "xlstm": tiny_xlstm(vocab_size=64)}
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
COUNTERS = ("prefill_calls", "prefill_grants", "resumed_grants",
            "decode_calls", "decode_tokens", "preemptions",
            "prefill_pad_tokens", "prefill_pad_rows", "prefix_shared_tokens",
            "cow_copies", "spec_calls", "completed")


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(ref_cfg.ssm))
    return ModelConfig(**kw)


_WEIGHTS = {}


@pytest.fixture(params=sorted(TWINS))
def twin(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    name = request.param
    if name not in _WEIGHTS:
        # made by the port from a seed and carried to the reference by the
        # bridge (the reference's own init compiles for seconds a twin)
        params = decoder.init_decoder_params(0, port_cfg(TWINS[name]),
                                             dtype=torch.float32,
                                             device="cpu")
        _WEIGHTS[name] = (jax.tree_util.tree_map(
            jnp.asarray, bridge.to_reference(params)), params)
    return (name, TWINS[name], port_cfg(TWINS[name])) + _WEIGHTS[name]


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


# prompts past hymba's 16-token window, resumed grants of 16, a pool too
# small for all three (a request evicted mid-decode re-prefills from zero
# state), and the reference's default features (sharing, packing,
# bucketing) with spec_k 2 asked for, which the gates turn off
PROMPTS = _prompts((41, 23, 9), 3)
SERVING = dict(prefill_token_budget=16, page_size=8, max_len=96,
               max_batch=3, num_pages=9, spec_k=2)


def _serve(eng, prompts, new, make_req, make_sp):
    rids = [eng.add_request(make_req(prompt=p.copy(), sampling=make_sp(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids]


def _paged(pcfg, params, **sv):
    return PagedEngine(Config(model=pcfg, parallel=ParallelConfig(data=1,
                                                                  model=1),
                              iso=PORT_ISO, serving=ServingConfig(**sv)),
                       params, device="cpu")


def test_paged_engine_equals_reference(twin):
    name, rcfg, pcfg, ref_params, params = twin
    prompts, new, sv = PROMPTS, 9, SERVING
    r_eng = RPagedEngine(RConfig(model=rcfg, parallel=RParallel(data=1,
                                                                model=1),
                                 iso=REF_ISO, serving=RServing(**sv)),
                         ref_params)
    want = _serve(r_eng, prompts, new, RRequest, RSampling)
    eng = _paged(pcfg, params, **sv)
    # the reference's gates (tests/test_prefix_sharing.py:196)
    assert eng.prefix_cache is None is r_eng.prefix_cache
    assert eng.spec_k == r_eng.spec_k == 0
    assert eng._buckets is None is r_eng._buckets
    assert not eng._batch_prefill and not r_eng._batch_prefill
    got = _serve(eng, prompts, new, Request, SamplingParams)
    assert got == want
    for k in COUNTERS:
        assert eng.metrics[k] == r_eng.metrics[k], (k, eng.metrics[k],
                                                     r_eng.metrics[k])
    m = eng.metrics
    assert m["prefill_calls"] == m["prefill_grants"]
    assert m["prefill_pad_tokens"] == 0 and m["resumed_grants"] > 0
    assert m["preemptions"] > 0
    assert eng.alloc.free_pages == eng.alloc.num_pages
    eng.alloc.check()
    assert eng.kv.kv_positions == ((0,) if name == "hybrid" else ())


def test_dense_engine_equals_reference(twin):
    """Prompts off the bucket grid: the pad tokens advance the state in
    both packages (the reference's semantics, ROADMAP queue C)."""
    name, rcfg, pcfg, ref_params, params = twin
    prompts = _prompts((41, 23, 9), 4)
    kw = dict(max_batch=2, max_len=96, bucket=16, spec_k=2)
    r_eng = REngine(RConfig(model=rcfg, parallel=RParallel(data=1, model=1),
                            iso=REF_ISO), ref_params, mesh=None, **kw)
    want = _serve(r_eng, prompts, 6, RRequest, RSampling)
    eng = Engine(Config(model=pcfg, parallel=ParallelConfig(data=1, model=1),
                        iso=PORT_ISO), params, device="cpu", **kw)
    assert eng.spec_k == r_eng.spec_k == 0
    if name == "hybrid":                  # the window bounds the ring
        assert eng.caches[0]["k"].shape[2] == 16
    got = _serve(eng, prompts, 6, Request, SamplingParams)
    assert got == want
    for k in eng.metrics:
        if not k.endswith("_s") and k != "ttft_sum":
            assert eng.metrics[k] == r_eng.metrics[k], k


def test_paged_equals_dense_on_pad_free_lengths(twin):
    """Prompt lengths that are multiples of the dense engine's bucket: the
    dense engine pads nothing, so the paged engine's resumed grants (state
    carried through the slot) give its tokens (the reference's
    tests/test_paged.py:264-290)."""
    name, rcfg, pcfg, ref_params, params = twin
    prompts = _prompts((32, 16, 48), 6)
    dense = Engine(Config(model=pcfg, parallel=ParallelConfig(data=1,
                                                              model=1),
                          iso=PORT_ISO), params, device="cpu", max_batch=3,
                   max_len=96, bucket=16)
    want = _serve(dense, prompts, 6, Request, SamplingParams)
    eng = _paged(pcfg, params, prefill_token_budget=16, page_size=8,
                 max_len=96, max_batch=3)
    got = _serve(eng, prompts, 6, Request, SamplingParams)
    assert got == want
    assert eng.metrics["resumed_grants"] > 0


def test_disagg_router_refuses_recurrent_stacks(twin):
    name, rcfg, pcfg, ref_params, params = twin
    sv = dict(page_size=8, max_batch=2, max_len=96, disagg=True)
    with pytest.raises(AssertionError, match="recurrent"):
        RDisaggRouter(RConfig(model=rcfg, parallel=RParallel(data=1, model=1),
                              iso=REF_ISO, serving=RServing(**sv)),
                      ref_params)
    with pytest.raises(AssertionError, match="recurrent"):
        DisaggRouter(Config(model=pcfg, parallel=ParallelConfig(data=1,
                                                                model=1),
                            iso=PORT_ISO, serving=ServingConfig(**sv)),
                     params, prefill_device="cpu")


@pytest.mark.parametrize("which", ["fresh", "resumed", "decode"])
def test_recurrent_closure_bodies_read_nothing_back(twin, which):
    """The recurrent stages run inside the engine's CUDA graphs: no closure
    body reads a tensor back to the host; a resumed grant reads its slot's
    state and writes it back, decode advances only the masked slots."""
    name, rcfg, pcfg, ref_params, params = twin
    eng = _paged(pcfg, params, page_size=8, max_batch=3, max_len=64)
    rows = np.asarray([[1, 2, 3, -1, -1, -1, -1, -1],
                       [4, 5, -1, -1, -1, -1, -1, -1],
                       [-1] * 8], np.int32)
    for t in eng._state_tensors:               # some state in every slot
        t.copy_(torch.randn(t.shape, generator=torch.Generator()
                            .manual_seed(t.numel())).to(t.dtype) * 0.1)
    before = [t.clone() for t in eng._state_tensors]
    if which in ("fresh", "resumed"):
        fn = eng._get_prefill(13, which == "resumed")
        fn.stage(tokens=np.ones((1, 13), np.int32), bt=rows[1:2],
                 start=5 if which == "resumed" else 0, n_real=13, slot=1)
        changed = {1}
    else:
        fn = eng._get_decode(1, 1)
        fn.stage(toks=np.ones((3, 1), np.int32),
                 lengths=np.asarray([20, 9, 0], np.int32), bt=rows,
                 mask=np.asarray([True, False, True]))
        changed = {0, 2}
    with _NoHostReads():
        out = fn()
    assert torch.isfinite(out).all()
    for old, new in zip(before, eng._state_tensors):
        for slot in range(3):
            same = torch.equal(old[:, slot], new[:, slot])
            assert same == (slot not in changed), (which, slot)
