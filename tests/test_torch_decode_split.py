"""The paged decode kernel's plain version at the widths of its edges, and
the merge algebra its design relies on, against the JAX Pallas
``_decode_kernel`` under the interpreter, on the same numpy-seeded inputs.

The decode kernel (``csrc/paged_attention.cu``) splits each span's pages
among 8 warps round-robin, each warp running the online softmax over its
pages, and merges the warps' states in warp order with the
``merge_softmax_states`` rule.  These tests guard ``decode_partials_plain``
(head dims 64 and 256, page size 32, 16 query rows, a row with no key, short
rows) and the identity: a walk folded with ``decode_reduce_plain`` from
sub-spans (contiguous, or the kernel's round-robin page sets) equals the
Pallas kernel's partial for the whole walk, and a sub-span with no key comes
back exactly neutral, (0, NEG_INF, 0).  They run none of the kernel's code:
only phase 2 of ``chip_smoke.py`` on the card checks the kernel itself."""
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
WARPS = 8                      # warps of a decode block (kDecWarps)


def _inputs(seed, lengths, ps, hq, hkv, hd, K, dtype, mb):
    """q (B, K, Hq, hd), pools with whole pages filled (keys past a row's
    length are poison the masks must hide), block tables of width mb."""
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
    if dtype == "bfloat16":
        import ml_dtypes
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
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


def _pallas_whole_walk(q, k, v, bt, lens, window):
    """The Pallas kernel's partial for the whole walk (one span: S = 1, so
    the reference returns the kernel's own output, no reduce)."""
    out = r_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(bt), jnp.asarray(lens),
                            window=window, kv_splits=1)
    return [torch.from_numpy(np.array(t, np.float32)) for t in out]


def _assert_neutral(o, m, l):
    assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0.0
    assert bool((m == np.float32(fd.NEG_INF)).all())


# (lengths, ps, Hq, Hkv, hd, K, window, dtype): head dims 64 and 256, page
# size 32, group 8 x K 2 = 16 query rows, a row with no key, short rows
WIDTHS = [
    ([1, 3, 0, 40, 77], 16, 4, 2, 64, 1, 0, "float32"),
    ([2, 0, 33, 17], 16, 4, 2, 256, 1, 9, "bfloat16"),
    ([1, 31, 32, 33, 0, 90], 32, 4, 2, 32, 2, 0, "float32"),
    ([3, 0, 20, 45], 8, 16, 2, 16, 2, 11, "float32"),
]


@pytest.mark.parametrize("lengths,ps,hq,hkv,hd,K,window,dtype", WIDTHS)
def test_decode_plain_matches_pallas_at_edge_widths(lengths, ps, hq, hkv, hd,
                                                    K, window, dtype):
    mb = -(-max(lengths) // ps) + 1
    q, k, v, bt, lens = _inputs(len(lengths) * hd + ps, lengths, ps, hq, hkv,
                                hd, K, dtype, mb)
    want = _pallas_whole_walk(q, k, v, bt, lens, window)
    qt = bridge.to_torch(q)
    got = fd.decode_partials_plain(
        _rows(qt, hkv), bridge.to_torch(k), bridge.to_torch(v),
        bridge.to_torch(bt), bridge.to_torch(lens), k_tokens=K,
        window=window, kv_splits=1)
    got = [_unrow(t[:, :, 0], K, hq) for t in got]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    # the row with no key is exactly the neutral state
    empty = lengths.index(0)
    _assert_neutral(*(t[empty] for t in got))


@pytest.mark.parametrize("split", ["contiguous", "round_robin"])
def test_sub_span_fold_equals_the_whole_walk(split):
    """Partials of disjoint page sets, folded by the reduce rule, equal the
    Pallas kernel's partial of the whole walk: four contiguous spans (the
    engine's split), or each warp's round-robin page set folded from one
    partial a page, then the warps folded in warp order (the kernel's
    merge).  Sets past a row's length come back exactly neutral."""
    lengths, ps, hq, hkv, hd, K = [0, 1, 40, 150, 300], 16, 4, 2, 32, 1
    mb = 20                       # 20 pages: warps own 3,3,3,3,2,2,2,2
    q, k, v, bt, lens = _inputs(5, lengths, ps, hq, hkv, hd, K, "float32",
                                mb)
    want = _pallas_whole_walk(q, k, v, bt, lens, 0)
    args = (_rows(bridge.to_torch(q), hkv), bridge.to_torch(k),
            bridge.to_torch(v), bridge.to_torch(bt), bridge.to_torch(lens))
    n_live = [-(-L // ps) for L in lengths]
    if split == "contiguous":
        S = 4                     # spans of 5 pages
        parts = fd.decode_partials_plain(*args, k_tokens=K, window=0,
                                         kv_splits=S)
        dead = [[s * 5 >= n for s in range(S)] for n in n_live]
    else:
        pages = fd.decode_partials_plain(*args, k_tokens=K, window=0,
                                         kv_splits=mb)
        warp_sets = [list(range(w, mb, WARPS)) for w in range(WARPS)]
        parts = [torch.stack(t, dim=2) for t in zip(*(
            fd.decode_reduce_plain(*(t[:, :, ids] for t in pages))
            for ids in warp_sets))]
        dead = [[ids[0] >= n for ids in warp_sets] for n in n_live]
    for b, row in enumerate(dead):
        for s, is_dead in enumerate(row):
            if is_dead:
                _assert_neutral(*(t[b, :, s] for t in parts))
    assert any(any(row) for row in dead) and not all(all(r) for r in dead)
    got = [_unrow(t, K, hq) for t in fd.decode_reduce_plain(*parts)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    _assert_neutral(*(t[0] for t in got))          # length 0: every set dead
