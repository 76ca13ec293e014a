"""The paged decode at more than 32 query rows, and the split-KV fold that
runs inside the decode launch, on CPU tensors (their plain versions) against
the JAX Pallas kernels under the interpreter, on the same numpy-seeded
inputs.

* ``flash_decode`` at group x K = 40 (group 8, a K = 5 verify window) and 64
  rows: the reference's ``_decode_kernel`` takes any number of rows, and so
  does the port (each 4-row tile is a block of its own on the card).
* ``decode_folded``, the walk with its S span partials folded (one launch on
  the card), against the reference's ``_decode_reduce`` of its
  ``_decode_kernel`` (``flash_decode`` at ``kv_splits=S``) at S = 2, 4, 7,
  with spans and rows that hold no key; and against ``decode_reduce`` of
  ``decode_partials``, the standalone fold of the same partials.

fp32 within 1e-5 (abs and rel): both sides accumulate in fp32 and differ
only in summation order.  The kernel itself is held against these plain
versions on the card by ``chip_smoke.py`` (phase 2), bit for bit for the
fold."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_decode as r_fd  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, lengths, ps, hq, hkv, hd, K, mb):
    """q (B, K, Hq, hd) and pools with whole pages filled (keys past a
    row's length are poison the masks must hide), tables of width mb."""
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-L // ps) for L in lengths) + 2
    k = rng.standard_normal((n_pages + 1, ps, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages + 1, ps, hkv, hd)).astype(np.float32)
    q = rng.standard_normal((len(lengths), K, hq, hd)).astype(np.float32)
    bt = np.full((len(lengths), mb), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for b, L in enumerate(lengths):
        for blk in range(-(-L // ps)):
            bt[b, blk] = free.pop()
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _rows(q, hkv):
    """(B, K, Hq, hd) -> the kernel's query rows (B, Hkv, gk, hd), g*K + qi."""
    B, K, hq, hd = q.shape
    return q.reshape(B, K, hkv, hq // hkv, hd).permute(0, 2, 3, 1, 4) \
        .reshape(B, hkv, hq // hkv * K, hd)


def _unrow(t, K, hq):
    B, hkv, gk, last = t.shape
    return t.reshape(B, hkv, gk // K, K, last).permute(0, 3, 1, 2, 4) \
        .reshape(B, K, hq, last)


def _pallas(q, k, v, bt, lens, window, S):
    out = r_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(bt), jnp.asarray(lens),
                            window=window, kv_splits=S)
    return [torch.from_numpy(np.array(t, np.float32)) for t in out]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL)


# (hq, hkv, K, S, window): group 8 x K 5 = 40 rows (a group-8 model's
# spec_k = 4 verify window), at one span and at three; group 16 x K 4 = 64
# rows with a window
MANY_ROWS = [(16, 2, 5, 1, 0), (16, 2, 5, 3, 9), (32, 2, 4, 2, 0)]


@pytest.mark.parametrize("hq,hkv,K,S,window", MANY_ROWS)
def test_flash_decode_takes_more_than_32_rows(hq, hkv, K, S, window):
    """gk = group * K past 32: the port returns the reference's state (it
    raised on either device while the kernel took at most 32 rows)."""
    lengths = [1, 9, 16, 30, 0]
    q, k, v, bt, lens = _inputs(40 + hq + K + S, lengths, 8, hq, hkv, 16, K,
                                mb=5)
    assert hq // hkv * K > 32
    want = _pallas(q, k, v, bt, lens, window, S)
    got = fd.flash_decode(*(bridge.to_torch(a) for a in (q, k, v, bt, lens)),
                          window=window, kv_splits=S)
    _close(got, want)
    # the row with no resident key is exactly neutral
    assert float(got[0][-1].abs().max()) == 0.0
    assert bool((got[1][-1] == np.float32(fd.NEG_INF)).all())


# (lengths, ps, hq, hkv, hd, K, S, window, mb): S = 2, 4, 7 spans; short rows
# leave the later spans with no key, a row of length 0 has none at all, and
# a ragged last span (MB % S != 0) aliases page 0 past the table
FOLDS = [
    ([1, 20, 40, 0], 8, 4, 2, 16, 1, 2, 0, 6),
    ([3, 17, 33, 64, 0], 8, 8, 2, 32, 2, 4, 12, 9),
    ([5, 100, 0, 57], 16, 4, 1, 16, 3, 7, 0, 8),
]


@pytest.mark.parametrize("lengths,ps,hq,hkv,hd,K,S,window,mb", FOLDS)
def test_decode_folded_matches_pallas_reduce_of_walk(lengths, ps, hq, hkv, hd,
                                                     K, S, window, mb):
    q, k, v, bt, lens = _inputs(60 + S, lengths, ps, hq, hkv, hd, K, mb)
    qt, kt, vt, btt, lt = (bridge.to_torch(a) for a in (q, k, v, bt, lens))
    qg = _rows(qt, hkv)
    kw = dict(k_tokens=K, window=window, kv_splits=S)
    parts = fd.decode_partials(qg, kt, vt, btt, lt, **kw)
    # a span with no key in it is exactly neutral, and some span is one
    empty = parts[2][..., 0] == 0
    assert bool(empty.any())
    assert bool((parts[1][..., 0][empty] == np.float32(fd.NEG_INF)).all())
    got = fd.decode_folded(qg, kt, vt, btt, lt, **kw)
    assert got[0].shape == (len(lengths), hkv, hq // hkv * K, hd)
    # the standalone fold of the same partials: the same code on the CPU
    for g, w in zip(got, fd.decode_reduce(*parts)):
        assert torch.equal(g, w)
    want = _pallas(q, k, v, bt, lens, window, S)
    _close([_unrow(t, K, hq) for t in got], want)
    assert float(got[0][lengths.index(0)].abs().max()) == 0.0
