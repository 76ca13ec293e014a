"""Whisper in the port (``models/whisper.py``: LayerNorm, the tanh GELU MLP,
sinusoidal positions, the bidirectional encoder, cross-attention, the
``dec_block`` decoder) against the JAX package, fp32 on the CPU at 2 + 2
layers, d 64, 4/4 heads and 16 frames, on bridged weights:

  * ``layer_norm``, the GELU MLP and ``sinusoidal_embedding`` (atol 1e-6 /
    1e-5 / 1e-6, 1e-4 at positions 440-447: fp32 ``exp`` differs by an ulp
    between XLA and torch);
  * ``encode`` at 1 and 2 ISO chunks, ``whisper_prefill``'s logits and its
    caches (self K/V and pos; cross K/V), and ``whisper_decode_step``'s
    logits and caches (atol 2e-5; pos equal);
  * the dense ``Engine``'s tokens with frames equal to the JAX ``Engine``'s
    and to a teacher-forced recomputation, counters equal; whisper runs no
    verify window (spec_k 0);
  * the bridge round trip of the ``{"encoder", "decoder"}`` tree, fp32 and
    bf16, through ``to_reference`` and ``save_npz``/``load_npz``;
  * the launcher on ``--arch whisper-medium --preset tiny --device cpu``
    without ``--paged``, and ``--paged`` refused for audio."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_whisper  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.layers import mlp as r_mlp  # noqa: E402
from repro.layers import norms as r_norms  # noqa: E402
from repro.layers import rope as r_rope  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models import whisper as r_whisper  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.layers import mlp, norms, rope  # noqa: E402
from repro_torch.models import api, whisper  # noqa: E402
from repro_torch.serving import Engine, PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_whisper(encoder_frames=16)
PORT_CFG = ModelConfig(**{f.name: getattr(REF_CFG, f.name)
                          for f in dataclasses.fields(ModelConfig)})
F, D = REF_CFG.encoder_frames, REF_CFG.d_model
# 2 ISO chunks at 16 frames (and on 16-token prompts), 1 with ISO off
ISOS = {1: (iso_cfg(enabled=False), ISOConfig(enabled=False)),
        2: (iso_cfg(2, min_chunk_tokens=4, chunk_align=4),
            ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=4,
                      chunk_align=4))}
ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, F, D)) * 0.1).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("what", ["layer_norm", "gelu_mlp", "sinusoid"])
def test_layers_equal_reference(what):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, D)).astype(np.float32) * 3 + 1
    if what == "layer_norm":
        scale = rng.standard_normal(D).astype(np.float32)
        bias = rng.standard_normal(D).astype(np.float32)
        got = norms.norm({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)},
                         torch.from_numpy(x), "ln", 1e-6)
        want = r_norms.norm({"scale": scale, "bias": bias}, jnp.asarray(x),
                            "ln", 1e-6)
        _close(got, want, 1e-6)
    elif what == "gelu_mlp":
        p = {"w_up": rng.standard_normal((D, 128)).astype(np.float32) * 0.1,
             "w_down": rng.standard_normal((128, D)).astype(np.float32) * 0.1}
        got = mlp.mlp_partial({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), "gelu")
        _close(got, r_mlp.mlp_partial(p, jnp.asarray(x), "gelu"), 1e-5)
    else:
        # XLA's and torch's fp32 exp differ by an ulp on some frequencies,
        # and the angle carries that error times the position: 1e-6 at the
        # encoder's positions, 1e-4 at whisper-medium's last decoder
        # positions (447 x ~1.2e-7)
        for n, d, off, atol in ((F, D, 0, 1e-6), (8, 1024, 440, 1e-4)):
            _close(rope.sinusoidal_embedding(n, d, off),
                   r_rope.sinusoidal_embedding(n, d, off), atol)


def test_make_inputs_carry_frames():
    batch = api.make_inputs(PORT_CFG, 12, 2, seed=3, dtype=torch.float32,
                            device="cpu")
    assert batch["tokens"].shape == (2, 12)
    assert batch["frames"].shape == (2, F, D)
    assert batch["frames"].dtype == torch.float32
    assert 0.05 < float(batch["frames"].std()) < 0.2
    assert int(batch["tokens"].max()) < PORT_CFG.vocab_size
    assert set(api.make_inputs(dataclasses.replace(PORT_CFG,
                                                   family="dense"), 4, 1,
                               device="cpu")) == {"tokens"}


@pytest.mark.parametrize("chunks", [1, 2])
def test_encode_equals_reference(weights, chunks):
    ref_params, params = weights
    riso, iso = ISOS[chunks]
    frames = _frames(0, 2)
    got = whisper.encode(params, PORT_CFG, AxisCtx(), iso,
                         torch.from_numpy(frames))
    want = r_whisper.encode(ref_params, REF_CFG, RAxisCtx(), riso,
                            jnp.asarray(frames))
    assert got.shape == (2, F, D)
    _close(got, want)


def _prefills(weights, chunks, toks, frames):
    ref_params, params = weights
    riso, iso = ISOS[chunks]
    got = api.prefill(params, PORT_CFG, AxisCtx(), iso,
                      {"frames": torch.from_numpy(frames),
                       "tokens": torch.from_numpy(toks)},
                      return_cache=True, cache_len=32)
    want = r_api.prefill(ref_params, REF_CFG, RAxisCtx(), riso,
                         {"frames": jnp.asarray(frames),
                          "tokens": jnp.asarray(toks)},
                         return_cache=True, cache_len=32)
    return got, want


@pytest.mark.parametrize("chunks", [1, 2])
def test_prefill_and_decode_equal_reference(weights, chunks):
    """``whisper_prefill``'s logits and caches (cross K/V included), then two
    decode steps (K = 1) on those caches: logits and the updated caches."""
    ref_params, params = weights
    rng = np.random.default_rng(chunks)
    toks = rng.integers(2, 128, (2, 16)).astype(np.int32)
    got, want = _prefills(weights, chunks, toks, _frames(chunks, 2))
    assert got["num_chunks"] == chunks
    _close(got["enc_out"], want["enc_out"])
    _close(got["logits_local"], want["logits_local"])
    caches, r_caches = got["caches"], want["caches"]
    assert set(caches[0]) == set(r_caches[0]) == \
        {"k", "v", "pos", "cross_k", "cross_v"}
    for name in ("k", "v", "cross_k", "cross_v"):
        _close(caches[0][name], r_caches[0][name])
    np.testing.assert_array_equal(caches[0]["pos"].numpy(),
                                  np.asarray(r_caches[0]["pos"]))
    lengths = np.array([16, 11], np.int32)
    for step in range(2):
        tok = rng.integers(2, 128, (2, 1)).astype(np.int32)
        lg, caches = api.decode_step(params, PORT_CFG, AxisCtx(),
                                     torch.from_numpy(tok), caches,
                                     torch.from_numpy(lengths + step))
        r_lg, r_caches = r_api.decode_step(ref_params, REF_CFG, RAxisCtx(),
                                           jnp.asarray(tok), r_caches,
                                           jnp.asarray(lengths + step))
        _close(lg, r_lg)
        for name in ("k", "v"):
            _close(caches[0][name], r_caches[0][name])
        np.testing.assert_array_equal(caches[0]["pos"].numpy(),
                                      np.asarray(r_caches[0]["pos"]))


def test_engine_tokens_equal_reference_and_teacher_forcing(weights):
    """Four requests with frames on two slots (slots reused, prompts 4-23
    tokens, two of them past the 16-token bucket): tokens equal to the JAX
    engine's and to the argmax of a teacher-forced prefill over prompt +
    generated; counters equal; a spec_k asked for is 0 on whisper."""
    ref_params, params = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 128, n).astype(np.int32)
               for n in (4, 23, 9, 17)]
    frames = _frames(7, len(prompts))
    riso, iso = ISOS[2]
    eng = Engine(Config(model=PORT_CFG, parallel=ParallelConfig(data=1,
                                                                model=1),
                        iso=iso), params, max_batch=2, max_len=64, bucket=16,
                 spec_k=3, device="cpu")
    ref = REngine(RConfig(model=REF_CFG, parallel=RParallel(data=1, model=1),
                          iso=riso), ref_params, mesh=None, max_batch=2,
                  max_len=64, bucket=16, spec_k=3)
    assert eng.spec_k == ref.spec_k == 0
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.add_request(Request(prompt=p.copy(), frames=f, rid=i,
                                sampling=SamplingParams(max_new_tokens=6,
                                                        eos_id=-1)))
        ref.add_request(RRequest(prompt=p.copy(), frames=f, rid=i,
                                 sampling=RSampling(max_new_tokens=6,
                                                    eos_id=-1)))
    got, want = eng.run_until_complete(), ref.run_until_complete()
    assert got == want and len(got) == 4
    untimed = [k for k in eng.metrics if not k.endswith("_s")
               and k != "ttft_sum"]
    assert {k: eng.metrics[k] for k in untimed} == \
        {k: ref.metrics[k] for k in untimed}
    for i, (p, f) in enumerate(zip(prompts, frames)):
        seq = np.concatenate([p, got[i]]).astype(np.int32)[None]
        out = api.prefill(params, PORT_CFG, AxisCtx(), ISOConfig(
            enabled=False), {"frames": torch.from_numpy(f[None]),
                             "tokens": torch.from_numpy(seq)})
        forced = out["logits_local"][0, len(p) - 1:-1,
                                     :PORT_CFG.vocab_size].argmax(-1)
        assert forced.tolist() == got[i]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip(dtype, tmp_path):
    ref = jax.tree_util.tree_map(np.asarray, r_api.init_params(
        jax.random.PRNGKey(1), REF_CFG, tp=1, dtype=dtype))
    params = bridge.from_reference(ref, device="cpu")
    assert set(params) == {"encoder", "decoder"}
    assert "embed" not in params["encoder"]
    layer = params["decoder"]["periods"][0][1]
    assert {"cross", "norm_cross"} <= set(layer)
    assert set(layer["norm1"]) == {"scale", "bias"}
    assert "w_gate" not in layer["mlp"]
    bridge.save_npz(tmp_path / "w.npz", ref)
    for tree in (bridge.to_reference(params),
                 bridge.load_npz(tmp_path / "w.npz")):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        want = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in flat] == [p for p, _ in want]
        for (_, a), (_, b) in zip(flat, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_launcher_serves_whisper_on_the_dense_engine(capsys):
    from repro_torch.launch import serve
    base = ["--arch", "whisper-medium", "--preset", "tiny", "--device",
            "cpu", "--dtype", "float32", "--requests", "3", "--prompt-len",
            "24", "--max-new", "4"]
    assert serve.main(base) == 0
    out = capsys.readouterr().out
    assert "arch=whisper-medium engine=dense" in out
    assert "completed=3" in out and "new_tokens=12" in out
    with pytest.raises(SystemExit) as exc:
        serve.main(base + ["--paged"])
    assert exc.value.code == 2
    assert "enc-dec" in capsys.readouterr().err
    params = api.init_params(0, PORT_CFG, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="dense Engine"):
        PagedEngine(Config(model=PORT_CFG), params, device="cpu")
