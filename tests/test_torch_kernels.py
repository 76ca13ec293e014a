"""The port's kernel wrappers on CPU tensors (their plain versions) against the
JAX Pallas kernels under the interpreter, on the same numpy-seeded inputs.

The int8 quantize grid is tests/test_kernels.py's ``test_int8_quant_sweep``,
plus an all-zero row and exact .5 ties; q and the scales must be EQUAL.

The decode grid covers every pair of (page size, K, S, window, dtype) values
of tests/test_flash_decode.py in nine cases (each case compiles its own
interpreted kernel, so the full product would cost minutes); the prefill
grid is tests/test_flash_prefill_paged.py's heterogeneous-row layout."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_decode as r_fd  # noqa: E402
from repro.kernels import int8_quant as r_q8  # noqa: E402
from repro.kernels.flash_prefill_paged import \
    flash_prefill_paged as r_prefill  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import int8_quant as q8  # noqa: E402
from repro_torch.kernels.flash_prefill_paged import \
    flash_prefill_paged  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pool(rng, lengths, ps, hkv, hd, num_pages, dtype, extra_blocks=0):
    """Random pool + block tables holding lengths[b] tokens per row; whole
    pages are filled, so keys past a row's length are poison the masks must
    hide."""
    B = len(lengths)
    mb = -(-max(max(lengths), 1) // ps) + extra_blocks
    k = rng.standard_normal((num_pages + 1, ps, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages + 1, ps, hkv, hd)).astype(np.float32)
    bt = np.full((B, mb), -1, np.int32)
    free = list(rng.permutation(num_pages))
    for b, L in enumerate(lengths):
        for blk in range(-(-L // ps)):
            bt[b, blk] = free.pop()
    if dtype == "bfloat16":
        import ml_dtypes
        k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return k, v, bt, np.asarray(lengths, np.int32)


def _t(a):
    return bridge.to_torch(a)


def _close(got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, **TOL)


# (page_size, K, S, window, dtype): a pairwise cover of the reference grid
DECODE_GRID = [
    (8, 1, 1, 0, "float32"), (16, 1, 2, 12, "float32"),
    (16, 1, 4, 0, "bfloat16"), (16, 2, 1, 12, "bfloat16"),
    (8, 2, 2, 0, "bfloat16"), (8, 2, 4, 12, "float32"),
    (16, 4, 1, 0, "float32"), (8, 4, 2, 12, "bfloat16"),
    (16, 4, 4, 12, "float32"),
]


@pytest.mark.parametrize("ps,K,S,window,dtype", DECODE_GRID)
def test_flash_decode_plain_matches_pallas(ps, K, S, window, dtype):
    rng = np.random.default_rng(100 + ps + 10 * K + S)
    lengths = [1, ps - 1, ps, ps + 1, 3 * ps - 2, 5 * ps - 3, 0]
    hq, hkv, hd = 4, 2, 16
    k, v, bt, lens = _pool(rng, lengths, ps, hkv, hd, 40, dtype,
                           extra_blocks=1)
    q = rng.standard_normal((len(lengths), K, hq, hd)).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        q = q.astype(ml_dtypes.bfloat16)
    want = r_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lens),
                             window=window, kv_splits=S)
    got = fd.flash_decode(_t(q), _t(k), _t(v), _t(bt), _t(lens),
                          window=window, kv_splits=S)
    for g, w in zip(got, want):
        _close(g, w)
    # the empty row is exactly the neutral state (0, NEG_INF, 0)
    assert float(got[0][-1].abs().max()) == 0.0
    assert float(got[2][-1].max()) == 0.0
    assert float(got[1][-1].max()) == float(np.float32(fd.NEG_INF))


def test_flash_decode_3d_query_squeezes():
    rng = np.random.default_rng(7)
    k, v, bt, lens = _pool(rng, [3, 11, 24], 8, 2, 16, 12, "float32")
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    want = r_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lens))
    got = fd.flash_decode(_t(q), _t(k), _t(v), _t(bt), _t(lens))
    assert got[0].shape == (3, 4, 16) and got[1].shape == (3, 4, 1)
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_reduce_plain_matches_pallas():
    """Span partials with neutral spans mixed in fold like the reference's
    reduce kernel."""
    rng = np.random.default_rng(8)
    B, Hkv, S, gk, hd = 3, 2, 4, 4, 16
    o = rng.standard_normal((B, Hkv, S, gk, hd)).astype(np.float32)
    m = rng.standard_normal((B, Hkv, S, gk, 1)).astype(np.float32) * 3
    l = rng.uniform(0.5, 9.0, (B, Hkv, S, gk, 1)).astype(np.float32)
    o[:, :, 1], m[:, :, 1], l[:, :, 1] = 0.0, fd.NEG_INF, 0.0   # empty span
    o[0], m[0], l[0] = 0.0, fd.NEG_INF, 0.0                    # empty row
    want = r_fd._decode_reduce(jnp.asarray(o), jnp.asarray(m),
                               jnp.asarray(l))
    got = fd.decode_reduce(_t(o), _t(m), _t(l))
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0][0].abs().max()) == 0.0
    assert float(got[2][0].max()) == 0.0


@pytest.mark.parametrize("ps,dtype,window", [(8, "float32", 0),
                                             (16, "bfloat16", 0),
                                             (8, "bfloat16", 5),
                                             (16, "float32", 12)])
def test_flash_prefill_paged_plain_matches_pallas(ps, dtype, window):
    """Heterogeneous rows: a fresh row (prefix 0) beside resumed rows at
    different depths, each with its own query start (mid-grant offsets)."""
    rng = np.random.default_rng(200 + ps + window)
    prefix_lens = [0, ps + 3, 3 * ps, 2 * ps - 1, 1]
    hq, hkv, hd = 4, 2, 16
    k, v, bt, lens = _pool(rng, prefix_lens, ps, hkv, hd, 40, dtype,
                           extra_blocks=1)
    Sq = ps + 2
    q = rng.standard_normal((len(prefix_lens), hq, Sq, hd)).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        q = q.astype(ml_dtypes.bfloat16)
    q_starts = lens + np.asarray([0, 3, 0, 5, 0], np.int32)
    want = r_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(bt), jnp.asarray(lens),
                     jnp.asarray(q_starts), window=window, block_q=8)
    got = flash_prefill_paged(_t(q), _t(k), _t(v), _t(bt), _t(lens),
                              _t(q_starts), window=window)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0][0].abs().max()) == 0.0           # fresh row: neutral
    assert float(got[2][0].max()) == 0.0


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(9, 8, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):                        # dtype mismatch
        fd.flash_decode(q.bfloat16(), k, k, bt, ln)
    with pytest.raises(ValueError):                       # pool shapes differ
        fd.flash_decode(q, k, k[:, :4], bt, ln)
    with pytest.raises(ValueError):                       # non-contiguous pool
        fd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        k, bt, ln)
    with pytest.raises(TypeError):                        # float block table
        fd.flash_decode(q, k, k, bt.float(), ln)
    with pytest.raises(ValueError):                       # lengths shape
        flash_prefill_paged(q[:, :, None], k, k, bt, ln[:1], ln)
    # the decode kernel's limit, checked from the shapes on either device
    wide = torch.zeros(9, 8, 2, 264)
    with pytest.raises(ValueError):                       # head_dim > 256
        fd.flash_decode(torch.zeros(2, 4, 264), wide, wide, bt, ln)
    # any number of query rows, as the reference: group*K 32, 33 and 36
    for q_rows in ((2, 4, 16, 16), (2, 1, 66, 16), (2, 3, 24, 16)):
        out = fd.flash_decode(torch.zeros(q_rows), k, k, bt, ln)
        assert out[0].shape == q_rows


def _q8_equal(x):
    want_q, want_s = r_q8.quantize_int8(jnp.asarray(x), interpret=True)
    got_q, got_s = q8.quantize_int8(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q.shape == x.shape and got_s.shape == (*x.shape[:-1], 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    return got_q, got_s


@pytest.mark.parametrize("shape", [(7, 64), (3, 37, 96), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quant_plain_matches_pallas(shape, dtype):
    x = np.random.default_rng(300 + len(shape)).standard_normal(shape)
    x = (x * 5).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
    _q8_equal(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quant_zero_row_and_ties(dtype):
    """amax 127 makes the scale exactly 1, so x/scale lands on .5 ties that
    round half to even; an all-zero row takes the floor scale, 1e-8 times
    the fp32 reciprocal of 127 (what the compiled reference kernel does)."""
    x = np.zeros((3, 8), np.float32)
    x[0] = [127, 2.5, 3.5, -0.5, -1.5, 0.5, -126.5, 126.5]
    x[2] = [-127, 0.25, 1.5, -2.5, 4.5, 64.5, 5.5, -3.5]
    if dtype == "bfloat16":
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
    q, s = _q8_equal(x)
    assert q[0].tolist() == [127, 2, 4, 0, -2, 0, -126, 126]
    assert q[1].abs().max() == 0
    floor = np.float32(1e-8) * (np.float32(1) / np.float32(127))
    assert float(s[1, 0]) == float(floor)


def test_int8_quant_rejects_bad_inputs():
    with pytest.raises(TypeError):
        q8.quantize_int8(torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        q8.quantize_int8(torch.zeros(2, 0))
