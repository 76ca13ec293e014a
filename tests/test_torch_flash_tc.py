"""The rounding of the bf16 tensor-core flash kernels (``csrc/flash_tc.cuh``,
behind B4 ``flash_attention`` and B3 ``flash_prefill_paged`` for bfloat16)
modelled in plain torch on the CPU, against the Pallas kernels under the
interpreter on the same numpy-seeded inputs.

The model follows the kernels step by step: scores are bf16 q . k summed in
fp32, scaled into log2 units; a per-64-key-tile online softmax with exp2;
p rounded to bf16 before p @ v; l summed from the fp32 p; m written back in
natural units; each 64-key tile of the paged kernel gathered through the
block table with the kernel's own address arithmetic.  The model states the
intended rounding and addressing; it runs none of the kernels' code, so a
change to either in ``csrc/flash_tc.cuh`` shows only on the card, where
``chip_smoke.py`` phase 2 holds each kernel against its plain version.
These tests pin how far that rounding may take the kernels from the
reference.  Tolerance: atol = rtol = 2e-2,
the bf16 tolerance of tests/test_kernels.py and of ``chip_smoke.py``
(p in bf16 keeps 8 bits; the outputs are averages of unit normals)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill as r_flash  # noqa: E402
from repro.kernels.flash_prefill_paged import \
    flash_prefill_paged as r_prefill  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.flash_decode import NEG_INF  # noqa: E402
from repro_torch.kernels.flash_prefill_paged import BLOCK_ROWS  # noqa: E402
from test_torch_kernels import _pool  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=2e-2, rtol=2e-2)
TILE = 64                                   # keys per tile (kTcKeys)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)


def tc_model(q, k, v, valid, hd):
    """One block's rows through the kernels' arithmetic.  q (R, hd), k and v
    (K, hd) bf16; valid (R, K) bool.  Returns fp32 (out, m, l) per row."""
    R, K = valid.shape
    scale_log2 = torch.tensor(hd ** -0.5, dtype=torch.float32) * LOG2E
    m = torch.full((R,), NEG_INF, dtype=torch.float32)
    l = torch.zeros(R)
    o = torch.zeros(R, q.shape[1])
    for k0 in range(0, K, TILE):
        ok = valid[:, k0:k0 + TILE]
        s = (q.float() @ k[k0:k0 + TILE].float().T) * scale_log2
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[:, None]) * ok
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None] + p.bfloat16().float() @ v[k0:k0 + TILE].float()
        m = mx
    out = o / torch.clamp(l, min=1e-30)[:, None]
    m_nat = torch.where(m == NEG_INF, m, m * LN2)
    return out, m_nat, l


def _bf16(rng, shape):
    import ml_dtypes
    return rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _close(got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want, **TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd", [
    (1, 2, 2, 16, 16, 32),     # MHA, no prefix
    (2, 4, 2, 48, 80, 64),     # GQA with prefix
    (1, 8, 1, 33, 70, 128),    # MQA, ragged lengths
])
def test_flash_tc_model_matches_pallas(B, Hq, Hkv, Sq, Sk, hd):
    """B4's bf16 kernel: each query row over 64-key tiles (the row blocks,
    128 rows on the card, do not enter a row's arithmetic), causal with the
    prefix in front; bf16 output."""
    rng = np.random.default_rng(42 + Sq)
    q, k, v = (_bf16(rng, s) for s in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                                       (B, Hkv, Sk, hd)))
    q_start = Sk - Sq
    want = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_start=q_start, block_q=16, block_k=32, interpret=True)
    tq, tk, tv = (bridge.to_torch(a) for a in (q, k, v))
    pos = q_start + torch.arange(Sq)[:, None]
    valid = torch.arange(Sk)[None, :] <= pos
    got = torch.empty(B, Hq, Sq, hd, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(Hq):
            hk = h // (Hq // Hkv)
            for r0 in range(0, Sq, TILE):
                rows = slice(r0, r0 + TILE)
                out, _, _ = tc_model(tq[b, h, rows], tk[b, hk], tv[b, hk],
                                     valid[rows], hd)
                got[b, h, rows] = out.bfloat16()
    _close(got, want)


def tile_rows(bt_row, klen, ps, hkv, h, k0, num_pages):
    """Rows of the flattened pool (N * ps * Hkv, hd) that feed keys k0 ..
    k0 + 63 of a paged tile, as ``kv_off`` in paged_attention.cu addresses
    them (its element offset over hd); -1 where the key is past the prefix
    (the tile zero-fills it)."""
    rows = []
    for key in range(k0, k0 + TILE):
        if key >= klen:
            rows.append(-1)
            continue
        j = key // ps
        page = min(max(int(bt_row[j]), 0), num_pages - 1)
        rows.append((page * ps + key - j * ps) * hkv + h)
    return rows


def paged_tc_model(q, k_pages, v_pages, bt, prefix_lens, q_starts, window):
    """B3's bf16 kernel, block by block: the group's rows g * bq + i of
    (query block iq, kv head h) in blocks of 64, 64-key tiles gathered
    from the pages."""
    B, Hq, Sq, hd = q.shape
    N, ps, Hkv, _ = k_pages.shape
    MB = bt.shape[1]
    group = Hq // Hkv
    bq = max(1, BLOCK_ROWS // group)
    R = group * bq
    kf = k_pages.reshape(-1, hd)
    vf = v_pages.reshape(-1, hd)
    zero = torch.zeros(1, hd, dtype=k_pages.dtype)
    out = torch.zeros(B, Hq, Sq, hd)
    m_out = torch.zeros(B, Hq, Sq, 1)
    l_out = torch.zeros(B, Hq, Sq, 1)
    for b in range(B):
        klen = max(0, min(int(prefix_lens[b]), MB * ps))
        n_keys = -(-klen // TILE) * TILE
        for h in range(Hkv):
            rows = [r for t in range(0, n_keys, TILE)
                    for r in tile_rows(bt[b], klen, ps, Hkv, h, t, N)]
            idx = torch.tensor(rows, dtype=torch.long)
            k = torch.cat([kf, zero])[torch.where(idx < 0, len(kf), idx)]
            v = torch.cat([vf, zero])[torch.where(idx < 0, len(vf), idx)]
            for iq in range(-(-Sq // bq)):
                for rb in range(0, R, TILE):
                    rr = torch.arange(rb, min(R, rb + TILE))
                    g, i = rr // bq, rr % bq
                    qi = iq * bq + i
                    live = qi < Sq
                    g, i, qi = g[live], i[live], qi[live]
                    key = torch.arange(n_keys)[None, :]
                    valid = key < klen
                    if window:
                        q0 = int(q_starts[b]) + iq * bq
                        valid = valid & (key > q0 + i[:, None] - window)
                    valid = valid.expand(len(qi), n_keys)
                    o, m, l = tc_model(q[b, h * group + g, qi], k, v, valid,
                                       hd)
                    out[b, h * group + g, qi] = o
                    m_out[b, h * group + g, qi, 0] = m
                    l_out[b, h * group + g, qi, 0] = l
    return out, m_out, l_out


@pytest.mark.parametrize("ps,window", [(16, 0), (8, 5)])
def test_paged_tc_model_matches_pallas(ps, window):
    """B3's bf16 kernel on the heterogeneous rows of
    tests/test_torch_kernels.py: a fresh row (prefix 0) beside resumed rows
    at different depths, each with its own query start."""
    rng = np.random.default_rng(200 + ps + window)
    prefix_lens = [0, ps + 3, 3 * ps, 2 * ps - 1, 1]
    hq, hkv, hd = 4, 2, 16
    k, v, bt, lens = _pool(rng, prefix_lens, ps, hkv, hd, 40, "bfloat16",
                          extra_blocks=1)
    Sq = ps + 2
    q = _bf16(rng, (len(prefix_lens), hq, Sq, hd))
    q_starts = lens + np.asarray([0, 3, 0, 5, 0], np.int32)
    want = r_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(bt), jnp.asarray(lens),
                     jnp.asarray(q_starts), window=window, block_q=8)
    got = paged_tc_model(*(bridge.to_torch(a) for a in (q, k, v, bt, lens,
                                                        q_starts)), window)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0][0].abs().max()) == 0.0           # fresh row: neutral
    assert float(got[2][0].max()) == 0.0
    assert float(got[1][0].max()) == float(np.float32(NEG_INF))


def tc_smem_bytes(hd, m):
    """Shared-memory bytes of a bf16 block as ``csrc/flash_tc.cuh`` lays it
    out (its ``tc_smem_bytes``): two stages of 64-key K and V tiles and,
    unless Q is held in registers (one m-tile a warp, up to hd 128), a Q
    tile of 64 * m rows; bf16 rows of hd rounded up to 16, plus 8.  The
    paged kernel's warps own one m-tile each, the dense kernel's two up to
    hd 128."""
    q_tiles = 0 if m == 1 and hd <= 128 else m
    return (4 + q_tiles) * TILE * (-(-hd // 16) * 16 + 8) * 2


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
def test_tc_tiles_fit_and_gather_the_prefix(ps):
    """The bf16 blocks' shared memory fits the card's 232,448 B per block
    for every head_dim <= 256, in both kernels (the build asserts it for
    the kernels' own count, instantiation by instantiation); the page size
    does not enter it, since a paged tile is 64 keys gathered from
    ceil(64 / ps) pages.  At hd 128 three paged blocks (68 KB) or two
    dense ones (102 KB) fit on an SM (228 KB).  And the tile gather reads,
    key by key, the rows the plain version's dense gather reads for keys
    inside the prefix."""
    for hd in range(1, native.MAX_HEAD_DIM + 1):
        for m in (1, 2 if hd <= 128 else 1):
            assert tc_smem_bytes(hd, m) <= native.MAX_SMEM_BYTES
    assert tc_smem_bytes(256, 1) == 168960
    assert tc_smem_bytes(128, 1) == 69632
    assert tc_smem_bytes(128, 2) == 104448
    assert 3 * 69632 <= 228 * 1024 and 2 * 104448 <= 228 * 1024
    rng = np.random.default_rng(ps)
    N, hkv, MB = 30, 2, -(-150 // ps) + 1
    bt = np.full(MB, -1, np.int32)
    bt[:-(-150 // ps)] = rng.permutation(N)[:-(-150 // ps)]
    ids = np.arange(N * ps * hkv).reshape(N, ps, hkv)
    dense = ids[np.clip(bt, 0, N - 1)].reshape(MB * ps, hkv)
    for klen in (1, 63, 64, 65, 150):
        for h in range(hkv):
            rows = [r for t in range(0, -(-klen // TILE) * TILE, TILE)
                    for r in tile_rows(bt, klen, ps, hkv, h, t, N)]
            assert rows[:klen] == dense[:klen, h].tolist()
            assert all(r == -1 for r in rows[klen:])
