"""Each ported layer function against its JAX twin on the same numpy-seeded
inputs (fp32, atol 1e-5), plus the framework-free copies (head layout,
chunking, scheduler, page coordinates) against the reference's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.core import chunking as r_chunking  # noqa: E402
from repro.layers import attention as r_attn  # noqa: E402
from repro.layers import embeddings as r_emb  # noqa: E402
from repro.layers import heads as r_heads  # noqa: E402
from repro.layers import mlp as r_mlp  # noqa: E402
from repro.layers import norms as r_norms  # noqa: E402
from repro.layers import rope as r_rope  # noqa: E402
from repro.serving import kvcache as r_kv  # noqa: E402
from repro.serving.scheduler import TokenBudgetScheduler as RSched  # noqa: E402

from repro_torch.config import ISOConfig, ModelConfig  # noqa: E402
from repro_torch.core import chunking  # noqa: E402
from repro_torch.layers import attention as attn  # noqa: E402
from repro_torch.layers import embeddings as emb  # noqa: E402
from repro_torch.layers import heads  # noqa: E402
from repro_torch.layers import mlp  # noqa: E402
from repro_torch.layers import norms  # noqa: E402
from repro_torch.layers import rope  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.scheduler import TokenBudgetScheduler  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def port_cfg(ref):
    return ModelConfig(**{f: getattr(ref, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "qk_norm", "sliding_window")})


def _close(got, want, tol=TOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    w = torch.from_numpy(np.array(want))
    assert got.shape == w.shape, (got.shape, w.shape)
    torch.testing.assert_close(got, w.to(got.dtype), **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_params(rng, cfg):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {"wq": rng.standard_normal((d, hq, hd)) * 0.1,
         "wk": rng.standard_normal((d, hkv, hd)) * 0.1,
         "wv": rng.standard_normal((d, hkv, hd)) * 0.1,
         "wo": rng.standard_normal((hq, hd, d)) * 0.1,
         "q_norm": 1 + 0.1 * rng.standard_normal(hd),
         "k_norm": 1 + 0.1 * rng.standard_normal(hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def test_elementwise_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(norms.rms_norm(_t(x), _t(g)), r_norms.rms_norm(jnp.asarray(x),
                                                          jnp.asarray(g)))
    h = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.asarray([[3, 4, 5, 6, 7], [100, 101, 102, 103, 104]], np.int32)
    _close(rope.apply_rope(_t(h), _t(pos), 1e6),
           r_rope.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e6))
    _close(rope.apply_rope(_t(h), _t(pos[0]), 1e4),
           r_rope.apply_rope(jnp.asarray(h), jnp.asarray(pos[0]), 1e4))
    _close(attn._head_rms(_t(h), _t(g[:16]), 1e-6),
           r_attn._head_rms(jnp.asarray(h), jnp.asarray(g[:16]), 1e-6))


def test_embedding_head_and_mlp_match():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((48, 32)).astype(np.float32)
    head = rng.standard_normal((48, 32)).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 6)).astype(np.int32)   # some off-shard
    p_ref = {"table": jnp.asarray(table), "head": jnp.asarray(head)}
    p = {"table": _t(table), "head": _t(head)}
    for off in (0, 16):
        _close(emb.embed_partial(p, _t(tokens), off),
               r_emb.embed_partial(p_ref, jnp.asarray(tokens), off))
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    _close(emb.lm_head_local(p, _t(x)),
           r_emb.lm_head_local(p_ref, jnp.asarray(x)))
    w = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in
         (("w_up", (32, 96)), ("w_gate", (32, 96)), ("w_down", (96, 32)))}
    _close(mlp.mlp_partial({k: _t(v) for k, v in w.items()}, _t(x), "swiglu"),
           r_mlp.mlp_partial({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x), "swiglu"))
    # bf16 keeps the reference's rounding: silu(gate) cast before * up
    xb = x.astype(jnp.bfloat16)
    got = mlp.mlp_partial({k: _t(v).bfloat16() for k, v in w.items()},
                          _t(x).bfloat16(), "swiglu")
    want = r_mlp.mlp_partial({k: jnp.asarray(v, jnp.bfloat16)
                              for k, v in w.items()}, jnp.asarray(xb),
                             "swiglu")
    _close(got.float(), np.asarray(want, np.float32),
           dict(atol=2e-2, rtol=2e-2))


def test_head_layout_and_expand_heads_match():
    for hq, hkv, tp in ((32, 8, 1), (4, 2, 1), (25, 5, 4), (8, 2, 4)):
        a, b = heads.head_layout(hq, hkv, tp), r_heads.head_layout(hq, hkv, tp)
        assert a.__dict__ == b.__dict__
        w = np.random.default_rng(2).standard_normal((6, hq, 3)).astype(
            np.float32)
        want = np.asarray(r_heads.expand_heads(jnp.asarray(w), b.q_map, 1))
        np.testing.assert_array_equal(heads.expand_heads(w, a.q_map, 1), want)
        np.testing.assert_array_equal(
            heads.expand_heads(_t(w), a.q_map, 1).numpy(), want)


def test_projection_sdpa_merge_and_o_proj_match():
    rng = np.random.default_rng(3)
    rcfg = tiny_dense(vocab_size=32)
    cfg = port_cfg(rcfg)
    pr, pt = _attn_params(rng, rcfg)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = (np.arange(7)[None] + np.asarray([[0], [9]])).astype(np.int32)
    got = attn.project_qkv(pt, _t(x), cfg, _t(pos))
    want = r_attn.project_qkv(pr, jnp.asarray(x), rcfg, jnp.asarray(pos))
    _close(got, want)
    q, k, v = got
    kpos = (np.arange(7)[None] + np.asarray([[0], [9]])).astype(np.int32)
    valid = np.ones((2, 7), bool)
    valid[1, 5:] = False
    for window in (0, 3):
        g = attn.sdpa_partial(q, k, v, q_pos=_t(pos), k_pos=_t(kpos),
                              window=window, k_valid=_t(valid), group_eff=2)
        w = r_attn.sdpa_partial(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                q_pos=jnp.asarray(pos), k_pos=jnp.asarray(kpos),
                                window=window, k_valid=jnp.asarray(valid),
                                group_eff=2)
        _close(g, w)
    states = [rng.standard_normal(s).astype(np.float32) for s in
              ((2, 7, 4, 16), (2, 7, 4, 1), (2, 7, 4, 1))] * 2
    states[2] = np.abs(states[2])
    states[5] = np.abs(states[5])
    states[3][0], states[4][0], states[5][0] = 0.0, -1e30, 0.0   # empty state
    _close(attn.merge_softmax_states(*map(_t, states)),
           r_attn.merge_softmax_states(*map(jnp.asarray, states)))
    o = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    _close(attn.o_proj_partial(pt, _t(o)),
           r_attn.o_proj_partial(pr, jnp.asarray(o)))


def _pool(rng, lengths, ps, hkv, hd, num_pages):
    mb = -(-max(lengths) // ps) + 1
    k = rng.standard_normal((num_pages + 1, ps, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages + 1, ps, hkv, hd)).astype(np.float32)
    bt = np.full((len(lengths), mb), -1, np.int32)
    free = list(range(num_pages))
    for b, L in enumerate(lengths):
        for blk in range(-(-L // ps)):
            bt[b, blk] = free.pop()
    return k, v, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("window", [0, 12])
def test_prefill_attention_layers_match(window):
    """Dense prefill with a contiguous prefix and a pad tail, and paged
    prefill with intra-call chunk KV, against their JAX twins."""
    rng = np.random.default_rng(4)
    rcfg = tiny_dense(vocab_size=32, sliding_window=window)
    cfg = port_cfg(rcfg)
    pr, pt = _attn_params(rng, rcfg)
    x = (rng.standard_normal((2, 8, 64)) * 0.3).astype(np.float32)
    pk = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    pv = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    got = attn.attn_prefill_partial(pt, _t(x), cfg, 2, start_pos=5,
                                    prefix_kv=(_t(pk), _t(pv)),
                                    window=window, k_limit=11)
    want = r_attn.attn_prefill_partial(pr, jnp.asarray(x), rcfg, 2,
                                       start_pos=5,
                                       prefix_kv=(jnp.asarray(pk),
                                                  jnp.asarray(pv)),
                                       window=window, k_limit=11)
    _close(got, want)

    prefix = [13, 24]
    k, v, bt, lens = _pool(rng, prefix, 8, 2, 16, 12)
    ik = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    iv = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    ipos = (lens[:, None] + np.arange(4)[None]).astype(np.int32)
    start = lens + 4
    k_limit = start + np.asarray([8, 5], np.int32)
    got = attn.attn_prefill_paged_partial(
        pt, _t(x), cfg, 2, k_pages=_t(k), v_pages=_t(v), block_tables=_t(bt),
        prefix_lens=_t(lens), start_pos=_t(start), intra_kv=(_t(ik), _t(iv)),
        intra_pos=_t(ipos), window=window, k_limit=_t(k_limit))
    want = r_attn.attn_prefill_paged_partial(
        pr, jnp.asarray(x), rcfg, 2, k_pages=jnp.asarray(k),
        v_pages=jnp.asarray(v), block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray(lens), start_pos=jnp.asarray(start),
        intra_kv=(jnp.asarray(ik), jnp.asarray(iv)),
        intra_pos=jnp.asarray(ipos), window=window,
        k_limit=jnp.asarray(k_limit))
    _close(got, want)


@pytest.mark.parametrize("window,kv_splits", [(0, 1), (12, 4)])
def test_decode_attention_layer_matches(window, kv_splits):
    rng = np.random.default_rng(5)
    rcfg = tiny_dense(vocab_size=32, sliding_window=window)
    cfg = port_cfg(rcfg)
    pr, pt = _attn_params(rng, rcfg)
    k, v, bt, lens = _pool(rng, [13, 9, 29, 0], 8, 2, 16, 16)
    x = (rng.standard_normal((4, 1, 64)) * 0.3).astype(np.float32)
    got = attn.attn_decode_paged_partial(
        pt, _t(x), cfg, 2, k_pages=_t(k), v_pages=_t(v), block_tables=_t(bt),
        lengths=_t(lens), window=window, kv_splits=kv_splits)
    want = r_attn.attn_decode_paged_partial(
        pr, jnp.asarray(x), rcfg, 2, k_pages=jnp.asarray(k),
        v_pages=jnp.asarray(v), block_tables=jnp.asarray(bt),
        lengths=jnp.asarray(lens), window=window, kv_splits=kv_splits)
    _close(got, want)


def test_chunking_scheduler_and_page_coords_match():
    rcfg = tiny_dense()
    cfg = port_cfg(rcfg)
    for n in (1, 7, 16, 70, 300, 1000, 2048):
        for ri, pi in ((iso_cfg(2, min_chunk_tokens=8, chunk_align=8),
                        ISOConfig(num_chunks=2, min_chunk_tokens=8,
                                  chunk_align=8)),
                       (iso_cfg(3, split_policy="adaptive"),
                        ISOConfig(num_chunks=3, split_policy="adaptive",
                                  min_chunk_tokens=2, chunk_align=4)),
                       (r_chunking.ISOConfig(), ISOConfig())):
            assert chunking.split_chunks(n, pi, cfg) == \
                r_chunking.split_chunks(n, ri, rcfg)
    for args in ((2048, 16), (160, 16), (64, 1), (100, 8, (8, 32, 100))):
        assert chunking.grant_buckets(*args) == r_chunking.grant_buckets(*args)
    buckets = chunking.grant_buckets(512)
    rs, ps = RSched("priority", 20, buckets), TokenBudgetScheduler(
        "priority", 20, buckets)
    for rid, prio in ((1, 0), (2, 5), (3, 5)):
        rs.add(rid, prio)
        ps.add(rid, prio)
    states = [(1, 0, (8, 8)), (2, 0, (8, 8, 8)), (3, 8, (8, 8))]
    assert [g.__dict__ for g in ps.grant_prefill(states)] == \
        [g.__dict__ for g in rs.grant_prefill(states)]
    assert ps.pick_victim([1, 2, 3]) == rs.pick_victim([1, 2, 3])
    assert ps.pop_waiting() == rs.pop_waiting()

    bt = np.asarray([[4, 7, -1], [2, -1, -1], [-1, -1, -1]], np.int32)
    lens = np.asarray([15, 8, 0], np.int32)
    mask = np.asarray([True, True, False])
    got = kvcache.window_page_coords(_t(lens), _t(bt), 2, 8, 99,
                                     decode_mask=_t(mask))
    want = r_kv.window_page_coords(jnp.asarray(lens), jnp.asarray(bt), 2, 8,
                                   99, decode_mask=jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = np.arange(3, 30, dtype=np.int32)
    got = kvcache.token_page_coords(_t(pos), _t(bt[0]), 8, 99)
    want = r_kv.token_page_coords(jnp.asarray(pos), jnp.asarray(bt[0]), 8, 99)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_config_copies_keep_every_field_and_default():
    """The port's config dataclasses keep the reference's fields and
    defaults (ServingConfig in full; the settings outside the slice raise in
    the engine rather than being dropped)."""
    import dataclasses
    from repro import config as r_config
    from repro_torch import config as p_config
    for name in ("ServingConfig", "ISOConfig", "RuntimeConfig",
                 "ModelConfig"):
        ref = {f.name: (f.default, f.default_factory) for f in
               dataclasses.fields(getattr(r_config, name))}
        port = {f.name: (f.default, f.default_factory) for f in
                dataclasses.fields(getattr(p_config, name))}
        assert port == ref, name
    assert p_config.padded_vocab(port_cfg(tiny_dense()), 1) == \
        r_config.padded_vocab(tiny_dense(), 1)
