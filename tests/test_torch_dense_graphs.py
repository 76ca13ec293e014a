"""The dense-cache ``Engine``'s compiled closures (``serving/engine.py``:
``_get_prefill`` / ``_get_decode``) against the JAX ``Engine``'s jitted
functions and against direct model calls, fp32 on the CPU at the
``tiny_dense`` size (and its hybrid, whisper and VLM twins).

On the card each closure is captured once in a CUDA graph and replayed; on
the CPU the same bodies run eagerly over the same static buffers, so these
tests run the code the card replays:

  * on mixed traffic (prompts across bucket boundaries, requests finishing
    mid-batch, ``spec_k`` on and off) the closure keys equal the reference's
    ``_prefill_fns`` keys (its prefill keys, the patch flag for the count,
    and its ``("spec", K)`` verify keys) and its decode function, with equal
    greedy tokens;
  * a prefill closure called at two slots leaves every cache leaf and
    ``pos`` equal to a batch-1 prefill written in with a Python-int slot
    (the engine's write before its closures), for the dense, hybrid
    (window 16, a prompt past it) and whisper (cross K/V) caches, and
    returns the sampled logits row;
  * the decode and verify closures equal direct ``api.decode_step`` calls,
    caches and recurrent states included;
  * the bodies read nothing back to the host, which a CUDA graph could not
    replay;
  * a second run on the same engine reuses its closures and gives a fresh
    engine's tokens, and a dropped engine is freed without the cycle
    collector."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_hybrid, tiny_vlm, \
    tiny_whisper  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402
from test_torch_graphs import _NoHostReads  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, SSMConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, Request, closures, \
    paged_engine  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
TWINS = {"dense": tiny_dense(vocab_size=64),
         "hybrid": tiny_hybrid(vocab_size=64),
         "whisper": tiny_whisper(vocab_size=64, encoder_frames=16),
         "vlm": tiny_vlm(vocab_size=64)}
ENGINE = dict(max_batch=3, max_len=96, bucket=16)


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(ref_cfg.ssm))
    return ModelConfig(**kw)


_WEIGHTS = {}


def weights(name):
    """(port params, reference params) of a twin, made by the port from a
    seed and carried to the reference by the bridge."""
    if name not in _WEIGHTS:
        params = api.init_params(0, port_cfg(TWINS[name]),
                                 dtype=torch.float32, device="cpu")
        _WEIGHTS[name] = (params, jax.tree_util.tree_map(
            jnp.asarray, bridge.to_reference(params)))
    return _WEIGHTS[name]


def _engine(name, **kw):
    config = Config(model=port_cfg(TWINS[name]),
                    parallel=ParallelConfig(data=1, model=1), iso=PORT_ISO)
    return Engine(config, weights(name)[0], device="cpu",
                  **dict(ENGINE, **kw))


def _ref_engine(name, **kw):
    config = RConfig(model=TWINS[name], parallel=RParallel(data=1, model=1),
                     iso=REF_ISO)
    return REngine(config, weights(name)[1], mesh=None, **dict(ENGINE, **kw))


def _extras(name, rng):
    """A request's frames (whisper) or patches (vlm) keyword, else none."""
    cfg = TWINS[name]
    if name == "whisper":
        return dict(frames=(rng.standard_normal(
            (cfg.encoder_frames, cfg.d_model)) * 0.1).astype(np.float32))
    if name == "vlm":
        return dict(patches=(rng.standard_normal(
            (cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32))
    return {}


def _serve(eng, make_req, make_sp, prompts, news, name="dense", seed=0):
    rng = np.random.default_rng(seed)
    rids = [eng.add_request(make_req(
        prompt=p.copy(), rid=i, sampling=make_sp(max_new_tokens=n,
                                                 eos_id=-1),
        **_extras(name, rng)))
        for i, (p, n) in enumerate(zip(prompts, news))]
    out = eng.run_until_complete()
    return [out[r] for r in rids]


def _prompts(lengths, seed, repeat=False):
    rng = np.random.default_rng(seed)
    if repeat:                  # repetitive: the self-draft gets accepted
        return [np.tile(rng.integers(2, 64, 6).astype(np.int32), n // 6 + 1
                        )[:n] for n in lengths]
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


# (name, twin, prompt lengths, new tokens each, engine kwargs): prompts on
# both sides of the 16-token buckets, more requests than slots, and new
# token counts that finish requests mid-batch
TRAFFIC = [
    ("plain", "dense", (7, 17, 33, 16, 40), (3, 6, 2, 5, 4), {}),
    # max_len 56: the 45-token prompt's last steps close the verify gate
    ("spec", "dense", (30, 19, 12, 45), (9, 3, 7, 11),
     dict(spec_k=3, max_len=56)),
    ("vlm", "vlm", (7, 20, 9), (3, 2, 4), {}),
]


@pytest.mark.parametrize("case", TRAFFIC, ids=[t[0] for t in TRAFFIC])
def test_closure_keys_and_tokens_equal_reference(case):
    label, name, lengths, news, kw = case
    prompts = _prompts(lengths, seed=len(label), repeat=label == "spec")
    eng, ref = _engine(name, **kw), _ref_engine(name, **kw)
    got = _serve(eng, Request, SamplingParams, prompts, news, name)
    want = _serve(ref, RRequest, RSampling, prompts, news, name)
    assert got == want
    assert [len(t) for t in got] == list(news)
    # the reference keeps its verify jits beside its prefill jits, keyed
    # ("spec", K); its prefill key flags the patches the port counts
    keys = {(b, f, n > 0) for b, f, n in eng._prefill_fns} | \
        {("spec", K) for K in eng._decode_fns if K > 1}
    assert keys == set(ref._prefill_fns)
    assert (1 in eng._decode_fns) == (ref._decode_fn is not None)
    if kw.get("spec_k"):
        assert set(eng._decode_fns) == {1, kw["spec_k"] + 1}
        assert eng.metrics["spec_accepted"] > 0
    if name == "vlm":
        assert {n for _, _, n in eng._prefill_fns} == \
            {TWINS[name].num_patches}
    assert not any(fn.graphed for fn in eng._prefill_fns.values())
    assert eng.graphs == 0


def _randomize(caches, gen):
    """Fill every cache leaf with noise (positions with random ints), so a
    write that strays from its slot shows."""
    for c in caches:
        for name, t in c.items():
            for leaf in (t if isinstance(t, tuple) else (t,)):
                if leaf.dtype.is_floating_point:
                    leaf.copy_(torch.randn(leaf.shape, generator=gen))
                else:
                    leaf.copy_(torch.randint(-1, 50, leaf.shape,
                                             generator=gen))


def _clone(caches):
    return tuple({k: type(v)(*(t.clone() for t in v)) if isinstance(v, tuple)
                  else v.clone() for k, v in c.items()} for c in caches)


def _int_slot_write(caches, new_caches, slot: int, real_len: int):
    """The engine's slot write before its closures: Python-int slot, every
    leaf with a batch dim of 1 and each field of a recurrent state copied
    in, then ``pos >= real_len`` -> -1 in the slot."""
    for big, small in zip(caches, new_caches):
        for name, t in small.items():
            if isinstance(t, tuple):
                for b, s in zip(big[name], t):
                    b[:, slot].copy_(s[:, 0])
            elif t.ndim >= 2 and t.shape[1] == 1:
                big[name][:, slot].copy_(t[:, 0])
        if "pos" in big:
            pos = big["pos"][:, slot]
            pos.masked_fill_(pos >= real_len, -1)


def _assert_caches_equal(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            for a, b in zip(*((x if isinstance(x, tuple) else (x,))
                              for x in (g[name], w[name]))):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("name", ["dense", "hybrid", "whisper", "vlm"])
def test_prefill_closure_slot_write_equals_int_write(name):
    """One prefill closure, two calls at slots 2 and 0 (the hybrid's 21-token
    prompt pads to 32, past its 16-token window): every cache leaf equals
    the Python-int write of a direct batch-1 prefill, and the closure
    returns that prefill's logits row at the last real position."""
    eng = _engine(name)
    params = weights(name)[0]
    gen = torch.Generator().manual_seed(1)
    _randomize(eng.caches, gen)
    rng = np.random.default_rng(2)
    n_patches = TWINS[name].num_patches if name == "vlm" else 0
    for slot, plen in ((2, 21), (0, 18)):
        want = _clone(eng.caches)
        toks = np.zeros((1, 32), np.int32)
        toks[0, :plen] = rng.integers(2, 64, plen)
        host = dict(tokens=toks, slot=slot, n_real=plen + n_patches)
        extras = {k: v[None] for k, v in _extras(name, rng).items()}
        host.update(extras)
        fn = eng._get_prefill(32, name == "whisper", n_patches)
        fn.stage(**host)
        row = fn().clone()
        out = eng._prefill_fn(params, {k: torch.from_numpy(v) for k, v in
                                       dict(extras, tokens=toks).items()})
        _int_slot_write(want, out["caches"], slot, plen + n_patches)
        _assert_caches_equal(eng.caches, want)
        assert torch.equal(row, out["logits_local"][0, plen + n_patches - 1])
    assert len(eng._prefill_fns) == 1


@pytest.mark.parametrize("name,K", [("dense", 1), ("dense", 3),
                                    ("hybrid", 1), ("whisper", 1)])
def test_decode_closure_equals_direct_calls(name, K):
    """Two decode steps through one K closure, at different lengths, against
    direct ``api.decode_step`` calls on a copy of the caches: logits and
    every cache leaf (ring KV, positions, recurrent states) equal."""
    eng = _engine(name)
    params, cfg = weights(name)[0], port_cfg(TWINS[name])
    gen = torch.Generator().manual_seed(3)
    _randomize(eng.caches, gen)
    fn = eng._get_decode(K)
    rng = np.random.default_rng(4)
    for lens in ((5, 17, 0), (40, 6, 22)):
        toks = rng.integers(2, 64, (3, K)).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        want = _clone(eng.caches)
        fn.stage(tokens=toks, lengths=lens)
        got = fn().clone()
        logits, _ = api.decode_step(params, cfg, AxisCtx(),
                                    torch.from_numpy(toks), want,
                                    torch.from_numpy(lens))
        assert torch.equal(got, logits)
        _assert_caches_equal(eng.caches, want)
    assert list(eng._decode_fns) == [K]


@pytest.mark.parametrize("name,K", [("dense", 1), ("dense", 3),
                                    ("hybrid", 1)])
def test_capture_warm_up_is_undone(name, K):
    """A capture runs the body once (its warm-up) before it records: the
    warm-up's window in the rings is put back (``_save_window``) and its
    recurrent states (the closure's ``mutates``), so the replay after it
    reads the caches the warm-up found.  On the hybrid twin the lengths
    wrap its 16-slot ring, so the window overwrites live slots."""
    eng = _engine(name)
    params, cfg = weights(name)[0], port_cfg(TWINS[name])
    _randomize(eng.caches, torch.Generator().manual_seed(6))
    fn = eng._get_decode(K)
    toks = np.random.default_rng(7).integers(2, 64, (3, K)).astype(np.int32)
    lens = np.asarray([9, 37, 20], np.int32)
    want = _clone(eng.caches)
    fn.stage(tokens=toks, lengths=lens)
    restore = eng._save_window(fn)
    states = [t.clone() for t in eng._state_tensors]
    fn()                                              # the warm-up
    for t, old in zip(eng._state_tensors, states):
        t.copy_(old)
    restore()
    _assert_caches_equal(eng.caches, want)
    got = fn().clone()                                # the replay
    logits, _ = api.decode_step(params, cfg, AxisCtx(),
                                torch.from_numpy(toks), want,
                                torch.from_numpy(lens))
    assert torch.equal(got, logits)
    _assert_caches_equal(eng.caches, want)
    assert eng._save_window(eng._get_prefill(16, False, 0))() is None


@pytest.mark.parametrize("which", ["prefill", "prefill_hybrid",
                                   "prefill_whisper", "prefill_vlm",
                                   "decode", "verify", "decode_hybrid",
                                   "decode_whisper"])
def test_closure_bodies_read_nothing_back(which):
    kind, _, twin = which.partition("_")
    name = twin or "dense"
    eng = _engine(name)
    rng = np.random.default_rng(5)
    if kind == "prefill":
        n_patches = TWINS[name].num_patches if name == "vlm" else 0
        fn = eng._get_prefill(16, name == "whisper", n_patches)
        fn.stage(tokens=np.ones((1, 16), np.int32), slot=1,
                 n_real=11 + n_patches,
                 **{k: v[None] for k, v in _extras(name, rng).items()})
    else:
        fn = eng._get_decode(3 if kind == "verify" else 1)
        fn.stage(tokens=np.ones((3, fn.inputs["tokens"].shape[1]), np.int32),
                 lengths=np.asarray([4, 0, 9], np.int32))
    with _NoHostReads():
        out = fn()
    assert torch.isfinite(out).all()


def test_second_run_reuses_closures():
    prompts = _prompts((7, 17, 33, 16), seed=6)
    news = (4, 2, 5, 3)
    eng = _engine("dense")
    first = _serve(eng, Request, SamplingParams, prompts, news)
    fns = {**eng._prefill_fns, **{("d", K): f
                                  for K, f in eng._decode_fns.items()}}
    again = _serve(eng, Request, SamplingParams, prompts, news)
    fresh = _serve(_engine("dense"), Request, SamplingParams, prompts, news)
    assert again == fresh == first
    assert {**eng._prefill_fns, **{("d", K): f for K, f in
                                   eng._decode_fns.items()}} == fns


def test_dropped_engine_is_freed_without_the_cycle_collector():
    """Closure bodies hold the engine's params and caches, not the engine:
    with every closure kind built, dropping the last reference frees the
    engine and its caches at once."""
    import gc
    import weakref
    eng = _engine("dense", spec_k=2)
    _serve(eng, Request, SamplingParams, _prompts((30, 12), 7, repeat=True),
           (6, 3))
    assert eng._prefill_fns and set(eng._decode_fns) >= {3}
    refs = [weakref.ref(eng), weakref.ref(eng.caches[0]["k"])]
    gc.disable()
    try:
        del eng
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_engines_share_one_step_closure():
    assert paged_engine.StepClosure is closures.StepClosure
    assert not _engine("dense", cuda_graphs=True)._graphed


def test_frames_of_another_dtype_raise():
    eng = _engine("whisper")
    frames = _extras("whisper", np.random.default_rng(8))["frames"]
    with pytest.raises(ValueError, match="float32"):
        eng.add_request(Request(prompt=np.arange(2, 9, dtype=np.int32),
                                frames=frames.astype(np.float16)))
