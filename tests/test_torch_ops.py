"""The port's kernel entry point ``repro_torch.kernels.ops`` on CPU tensors
(the kernels' plain versions) against the reference's ``repro.kernels.ops``
with the Pallas kernels under the interpreter, on the same numpy-seeded
inputs.

The grids and tolerances are tests/test_kernels.py's: fp32 1e-5 (swiglu
1e-6), bf16 2e-2; int8 q and scales must be equal.  The flash kernel's rows
with no attended key are held against ``flash_prefill_ref`` instead, which
gives 0 there (the Pallas kernel leaves a padding-dependent value)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_prefill, int8_quant, ops, rmsnorm, \
    swiglu  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        import ml_dtypes
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _close(got, want, tol, dtype):
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd", [
    (1, 2, 2, 16, 16, 32),     # MHA, no prefix
    (2, 4, 2, 48, 80, 64),     # GQA with prefix
    (1, 8, 1, 33, 70, 128),    # MQA, ragged lengths
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, Hq, Hkv, Sq, Sk, hd, dtype):
    q, k, v = _inputs(42 + Sq, [(B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                                (B, Hkv, Sk, hd)], dtype)
    q_start = Sk - Sq
    want = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_start=q_start, block_q=16,
                                 block_k=32, interpret=True)
    got = ops.flash_attention(bridge.to_torch(q), bridge.to_torch(k),
                              bridge.to_torch(v), q_start=q_start)
    _close(got, want, TOL[dtype], dtype)


@pytest.mark.parametrize("window,causal", [(8, True), (24, True),
                                           (24, False), (0, False)])
def test_flash_attention_window_and_causal(window, causal):
    q, k, v = _inputs(5, [(1, 2, 32, 32), (1, 2, 64, 32), (1, 2, 64, 32)],
                      "float32")
    want = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_start=32, causal=causal,
                                 window=window, block_q=16, block_k=16,
                                 interpret=True)
    got = ops.flash_attention(bridge.to_torch(q), bridge.to_torch(k),
                              bridge.to_torch(v), q_start=32, causal=causal,
                              window=window)
    _close(got, want, 1e-5, "float32")


def test_flash_attention_chunked_equals_full():
    """flash(chunk0) ++ flash(chunk1 | prefix) == flash(full) through the
    port's ops, and equal to the Pallas kernel's full call: the ISO
    property at kernel level."""
    q, k, v = (bridge.to_torch(a) for a in _inputs(
        7, [(1, 2, 64, 32)] * 3, "float32"))
    full = ops.flash_attention(q, k, v)
    half = 32
    c0 = ops.flash_attention(q[:, :, :half], k[:, :, :half], v[:, :, :half])
    c1 = ops.flash_attention(q[:, :, half:], k, v, q_start=half)
    torch.testing.assert_close(torch.cat([c0, c1], dim=2), full, atol=1e-5,
                               rtol=1e-5)
    want = r_ops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 block_q=16, block_k=16, interpret=True)
    _close(full, want, 1e-5, "float32")


def test_flash_attention_empty_rows_are_zero():
    """Rows at q_start + i >= Sk - 1 + window attend no key: 0, as in
    flash_prefill_ref; the rows with a key match the Pallas kernel."""
    Sq, Sk, window, q_start = 8, 16, 4, 16
    q, k, v = _inputs(11, [(1, 4, Sq, 16), (1, 2, Sk, 16), (1, 2, Sk, 16)],
                      "float32")
    got = ops.flash_attention(bridge.to_torch(q), bridge.to_torch(k),
                              bridge.to_torch(v), q_start=q_start,
                              window=window)
    oracle = ref.flash_prefill_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_start=q_start,
                                   window=window)
    _close(got, oracle, 1e-5, "float32")
    empty = Sk - 1 + window - q_start          # first row with no key
    assert 0 < empty < Sq
    assert float(got[:, :, empty:].abs().max()) == 0.0
    pallas = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_start=q_start,
                                   window=window, block_q=8, block_k=8,
                                   interpret=True)
    _close(got[:, :, :empty], np.asarray(pallas)[:, :, :empty], 1e-5,
           "float32")


@pytest.mark.parametrize("shape", [(5, 128), (2, 33, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_pallas(shape, dtype):
    (x,) = _inputs(2, [shape], dtype)
    (g,) = _inputs(3, [(shape[-1],)], "float32")
    want = r_ops.rms_norm(jnp.asarray(x), jnp.asarray(g), interpret=True)
    got = ops.rms_norm(bridge.to_torch(x), bridge.to_torch(g))
    _close(got, want, TOL[dtype], dtype)


def test_rms_norm_bf16_gamma_odd_width():
    """A bf16 gamma and a row width (100) that forbids 16-byte loads."""
    x, g = _inputs(4, [(3, 100), (100,)], "bfloat16")
    want = r_ops.rms_norm(jnp.asarray(x), jnp.asarray(g), eps=1e-5,
                          interpret=True)
    got = ops.rms_norm(bridge.to_torch(x), bridge.to_torch(g), eps=1e-5)
    _close(got, want, TOL["bfloat16"], "bfloat16")


@pytest.mark.parametrize("shape", [(4, 512), (2, 17, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_pallas(shape, dtype):
    g, u = _inputs(6, [shape, shape], dtype)
    want = r_ops.swiglu(jnp.asarray(g), jnp.asarray(u), interpret=True)
    got = ops.swiglu(bridge.to_torch(g), bridge.to_torch(u))
    _close(got, want, 1e-6 if dtype == "float32" else 2e-2, dtype)


@pytest.mark.parametrize("shape", [(7, 64), (3, 37, 96), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_through_ops_equals_pallas(shape, dtype):
    (x,) = _inputs(300 + len(shape), [shape], "float32")
    x = x * 5
    if dtype == "bfloat16":
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
    want_q, want_s = r_ops.quantize_int8(jnp.asarray(x), interpret=True)
    got_q, got_s = ops.quantize_int8(bridge.to_torch(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_ops_names_are_the_kernel_wrappers():
    assert set(ops.__all__) == {"flash_attention", "rms_norm", "swiglu",
                                "quantize_int8"}
    assert ops.flash_attention is flash_prefill.flash_attention
    assert ops.rms_norm is rmsnorm.rms_norm
    assert ops.swiglu is swiglu.swiglu
    assert ops.quantize_int8 is int8_quant.quantize_int8


_q = torch.zeros(1, 4, 8, 16)
_kv = torch.zeros(1, 2, 8, 16)
_x = torch.zeros(3, 16)
_g = torch.ones(16)
_meta = dict(device="meta")

BAD_CALLS = {
    "flash int dtype": (TypeError, lambda: ops.flash_attention(
        _q.int(), _kv.int(), _kv.int())),
    "flash mixed dtypes": (TypeError, lambda: ops.flash_attention(
        _q, _kv.bfloat16(), _kv)),
    "flash k on another device": (ValueError, lambda: ops.flash_attention(
        _q, torch.zeros(1, 2, 8, 16, **_meta), _kv)),
    "flash k/v shapes differ": (ValueError, lambda: ops.flash_attention(
        _q, _kv, _kv[:, :, :4])),
    "flash Hq not a multiple of Hkv": (ValueError, lambda: ops.flash_attention(
        _q[:, :3], _kv, _kv)),
    "flash head_dim > 256": (ValueError, lambda: ops.flash_attention(
        torch.zeros(1, 2, 4, 272), torch.zeros(1, 2, 4, 272),
        torch.zeros(1, 2, 4, 272))),
    "rms_norm float16": (TypeError, lambda: ops.rms_norm(_x.half(), _g)),
    "rms_norm gamma on another device": (ValueError, lambda: ops.rms_norm(
        _x, torch.ones(16, **_meta))),
    "rms_norm gamma shape": (ValueError, lambda: ops.rms_norm(_x, _g[:8])),
    "swiglu mixed dtypes": (TypeError, lambda: ops.swiglu(_x, _x.bfloat16())),
    "swiglu up on another device": (ValueError, lambda: ops.swiglu(
        _x, torch.zeros(3, 16, **_meta))),
    "swiglu shapes differ": (ValueError, lambda: ops.swiglu(_x, _x[:2])),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_ops_reject_bad_inputs(case):
    exc, call = BAD_CALLS[case]
    with pytest.raises(exc):
        call()
