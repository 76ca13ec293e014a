"""The port's recurrent families (``layers/ssm.py``, ``layers/xlstm.py``,
the ``hybrid``/``mlstm``/``slstm`` blocks, their state caches and shard
rules) against the JAX package, on the CPU, fp32 within 1e-5 + 1e-5 rel,
on numpy inputs from a seed and weights carried across by the bridge:

  * the layers, the port's counterparts of tests/test_layers.py:97-191 each
    held against the reference's function: the SSM over a whole sequence
    and over two chunks with the state handed off, one decode step against
    the prefill's last row; the mLSTM at ``inner_chunk`` 4 and 16 and at an
    odd S (one whole-call chunk), and its handoff; the sLSTM's handoff;
  * the decoder on the reference's ``tiny_hybrid`` (window 16) and
    ``tiny_xlstm``: prefill logits and final states over 1 and 2 ISO chunks,
    a resumed paged prefill from carried states, paged decode with an
    inactive slot (its state untouched), dense decode on the prefill's
    caches;
  * init (fp32 leaves, rank shard == shard of the whole), the bridge round
    trip and ``save_npz``/``load_npz``, ``shard_params`` against
    ``decoder_param_specs`` (the sLSTM's leaves replicated, ``w_out``
    row-split in the SSM and split on dim 1 in the mLSTM), the state caches
    against the reference's ``init_state_caches`` and ``cache_specs``,
    ``reduce_cfg`` tiny, and the launcher on each tiny twin with and
    without ``--paged``.

The engines are in tests/test_torch_recurrent_serving.py, tp=2 over gloo in
tests/test_torch_tp.py."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from conftest import iso_cfg, tiny_hybrid, tiny_xlstm  # noqa: E402
from repro.config import ModelConfig as RModelConfig  # noqa: E402
from repro.config import SSMConfig as RSSMConfig  # noqa: E402
from repro.config import get_model_config as r_get  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.launch.train import reduce_cfg as r_reduce_cfg  # noqa: E402
from repro.layers import ssm as r_ssm  # noqa: E402
from repro.layers import xlstm as r_xlstm  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models import decoder as r_dec  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import ISOConfig, ModelConfig, SSMConfig, \
    get_model_config  # noqa: E402
from repro_torch.configs import RECURRENT  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch.serve import reduce_cfg  # noqa: E402
from repro_torch.layers import ssm, xlstm  # noqa: E402
from repro_torch.models import api, decoder  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(ref_cfg.ssm))
    return ModelConfig(**kw)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return bridge._map(_host(tree), bridge.to_torch) if isinstance(
        tree, dict) else type(tree)(*(bridge.to_torch(np.asarray(t))
                                      for t in tree))


def _close(got, want):
    if isinstance(got, tuple):
        assert type(got).__name__ == type(want).__name__
        for g, w in zip(got, want):
            _close(g, w)
        return
    torch.testing.assert_close(got.float(), torch.from_numpy(
        np.array(jnp.asarray(want).astype(jnp.float32))), **TOL)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

SCFG = RSSMConfig(state_dim=8, conv_dim=4, expand=2)
LCFG = RModelConfig(name="m", family="ssm", num_layers=2, d_model=32,
                    num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=32)


def test_ssm_chunk_handoff_and_decode_match_reference():
    rp = r_ssm.init_ssm(jax.random.PRNGKey(0), 32, SCFG, tp=1, num_layers=2,
                        dtype=jnp.float32)
    p = _torch(rp)
    scfg = SSMConfig(**dataclasses.asdict(SCFG))
    r_partial = jax.jit(r_ssm.ssm_partial, static_argnums=2)
    rx, x = _x((2, 20, 32))
    y_r, st_r = r_partial(rp, rx, SCFG)
    y, st = ssm.ssm_partial(p, x, scfg)
    _close(y, y_r)
    _close(st, st_r)
    # two chunks, the state handed off (the reference's own split)
    y0_r, st0_r = r_partial(rp, rx[:, :8], SCFG)
    y1_r, st1_r = r_partial(rp, rx[:, 8:], SCFG, st0_r)
    y0, st0 = ssm.ssm_partial(p, x[:, :8], scfg)
    y1, st1 = ssm.ssm_partial(p, x[:, 8:], scfg, st0)
    _close(torch.cat([y0, y1], 1), jnp.concatenate([y0_r, y1_r], 1))
    _close(st1, st1_r)
    _close(torch.cat([y0, y1], 1), y_r)
    # one decode step == the prefill's row
    yd_r, _ = jax.jit(r_ssm.ssm_decode_partial, static_argnums=2)(
        rp, rx[:, 19:20], SCFG, r_partial(rp, rx[:, :19], SCFG)[1])
    yd, _ = ssm.ssm_decode_partial(p, x[:, 19:20], scfg,
                                   ssm.ssm_partial(p, x[:, :19], scfg)[1])
    _close(yd, yd_r)
    _close(yd[:, 0], y_r[:, 19])


@pytest.mark.parametrize("S,chunk", [(12, 4), (16, 16), (13, 4)],
                         ids=["c4", "c16", "odd13"])
def test_mlstm_matches_reference(S, chunk):
    rp = r_xlstm.init_mlstm(jax.random.PRNGKey(0), LCFG, tp=1,
                            dtype=jnp.float32)
    p = _torch(rp)
    cfg = port_cfg(LCFG)
    rx, x = _x((2, S, 32))
    y_r, st_r = r_xlstm.mlstm_partial(rp, rx, LCFG, inner_chunk=chunk)
    y, st = xlstm.mlstm_partial(p, x, cfg, inner_chunk=chunk)
    _close(y, y_r)
    _close(st, st_r)
    # the handoff: two calls of S // 2 (an odd S splits 6 + 7)
    h = S // 2
    y0_r, s0_r = r_xlstm.mlstm_partial(rp, rx[:, :h], LCFG, inner_chunk=chunk)
    y1_r, _ = r_xlstm.mlstm_partial(rp, rx[:, h:], LCFG, s0_r,
                                    inner_chunk=chunk)
    y0, s0 = xlstm.mlstm_partial(p, x[:, :h], cfg, inner_chunk=chunk)
    y1, _ = xlstm.mlstm_partial(p, x[:, h:], cfg, s0, inner_chunk=chunk)
    _close(torch.cat([y0, y1], 1), jnp.concatenate([y0_r, y1_r], 1))
    _close(torch.cat([y0, y1], 1), y_r)


def test_slstm_handoff_matches_reference():
    rp = r_xlstm.init_slstm(jax.random.PRNGKey(0), LCFG, dtype=jnp.float32)
    p = _torch(rp)
    cfg = port_cfg(LCFG)
    rx, x = _x((2, 12, 32))
    y_r, st_r = r_xlstm.slstm_forward(rp, rx, LCFG)
    y0, st0 = xlstm.slstm_forward(p, x[:, :5], cfg)
    y1, st1 = xlstm.slstm_forward(p, x[:, 5:], cfg, st0)
    _close(torch.cat([y0, y1], 1), y_r)
    _close(st1, st_r)
    assert torch.equal(xlstm.init_slstm_state(2, 32).n, torch.ones(2, 32))


# ---------------------------------------------------------------------------
# the decoder on bridged weights
# ---------------------------------------------------------------------------

TWINS = {"hybrid": tiny_hybrid(vocab_size=64),
         "xlstm": tiny_xlstm(vocab_size=64)}
PS, NP = 8, 12
_WEIGHTS = {}


@pytest.fixture(params=sorted(TWINS))
def twin(request):
    name = request.param
    if name not in _WEIGHTS:
        # the port's weights from a seed, carried to the reference by the
        # bridge (the reference's own init compiles for seconds a twin)
        params = decoder.init_decoder_params(0, port_cfg(TWINS[name]),
                                             dtype=torch.float32,
                                             device="cpu")
        _WEIGHTS[name] = (jax.tree_util.tree_map(
            jnp.asarray, bridge.to_reference(params)), params)
    return (name, TWINS[name], port_cfg(TWINS[name])) + _WEIGHTS[name]


def _isos(chunks):
    return (iso_cfg(chunks, min_chunk_tokens=8, chunk_align=8),
            ISOConfig(enabled=True, num_chunks=chunks, min_chunk_tokens=8,
                      chunk_align=8))


def _states(extras):
    return [{k: v for k, v in e.items() if k in ("ssm", "mlstm", "slstm")}
            for e in extras]


@pytest.mark.parametrize("chunks", [1, 2])
def test_prefill_logits_and_states_match(twin, chunks):
    _, rcfg, pcfg, ref, params = twin
    toks = np.random.default_rng(0).integers(0, 64, (2, 24)).astype(np.int32)
    r_iso, p_iso = _isos(chunks)
    want = r_dec.prefill(ref, rcfg, RAxisCtx(), r_iso,
                         tokens=jnp.asarray(toks), return_extras=True)
    got = decoder.prefill(params, pcfg, AxisCtx(), p_iso,
                          tokens=torch.from_numpy(toks), return_extras=True)
    assert got["num_chunks"] == want["num_chunks"] == chunks
    _close(got["logits_local"], want["logits_local"])
    for g, w in zip(_states(got["extras"]), _states(want["extras"])):
        assert set(g) == set(w) and g
        for k in g:
            _close(g[k], w[k])


def _rand_states(cfg, B, seed):
    """Reference-layout state caches with random contents (P, B, ...)."""
    st = r_api.init_state_caches(cfg, B, tp=1, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * 0.3)
                              .astype(np.float32)), st)


def _port_caches(ref_caches):
    return tuple({k: (bridge.to_torch(np.asarray(v)) if not isinstance(
        v, tuple) else type(v)(*(bridge.to_torch(np.array(t)) for t in v)))
        for k, v in c.items()} for c in ref_caches)


def _pools(cfg, rng):
    P_ = cfg.num_layers // len(cfg.block_pattern)
    shape = (P_, NP + 1, PS, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def test_resumed_paged_prefill_matches(twin):
    """A 13-token grant resuming at position 21 (past hymba's window of 16)
    from carried states and, for hymba, a page-resident prefix, over 2 ISO
    chunks: logits and final states."""
    name, rcfg, pcfg, ref, params = twin
    rng = np.random.default_rng(1)
    states = _rand_states(rcfg, 1, 2)
    r_prefix = [dict(c) for c in states]
    bt = np.asarray([[5, 2, 9, 0, -1, -1]], np.int32)
    if name == "hybrid":
        kp, vp = _pools(rcfg, rng)
        r_prefix[0].update(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp))
    p_prefix = _port_caches(r_prefix)
    toks = rng.integers(0, 64, (1, 16)).astype(np.int32)
    r_iso, p_iso = _isos(2)
    want = r_dec.prefill(
        ref, rcfg, RAxisCtx(), r_iso, tokens=jnp.asarray(toks),
        prefix_caches=tuple(r_prefix), block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray([21], jnp.int32), pos_offset=21,
        return_extras=True)
    got = decoder.prefill(
        params, pcfg, AxisCtx(), p_iso, tokens=torch.from_numpy(toks),
        prefix_caches=p_prefix, block_tables=torch.from_numpy(bt),
        prefix_lens=torch.tensor([21], dtype=torch.int32), pos_offset=21,
        return_extras=True)
    assert got["num_chunks"] == 2
    _close(got["logits_local"], want["logits_local"])
    for g, w in zip(_states(got["extras"]), _states(want["extras"])):
        for k in g:
            _close(g[k], w[k])


def test_paged_decode_step_matches(twin):
    """Batched paged decode (slot 2 inactive, its state left as it was) and
    split-KV S=1 and S=4 on the port's side: logits, the pools' in-place
    update and the states advanced in place against the reference's
    decode_step plus its engine's ``jnp.where`` on the active slots."""
    name, rcfg, pcfg, ref, params = twin
    rng = np.random.default_rng(3)
    states = _rand_states(rcfg, 3, 4)
    caches = [dict(c) for c in states]
    if name == "hybrid":
        kp, vp = _pools(rcfg, rng)
        caches[0].update(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp))
    bt = np.asarray([[3, 7, 1, 6], [4, 10, -1, -1], [-1, -1, -1, -1]],
                    np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    mask = np.asarray([True, True, False])
    toks = rng.integers(0, 64, (3, 1)).astype(np.int32)
    want, new = r_dec.decode_step(
        ref, rcfg, RAxisCtx(), jnp.asarray(toks), tuple(caches),
        jnp.asarray(lens), block_tables=jnp.asarray(bt),
        decode_mask=jnp.asarray(mask))
    for S in (1, 4):
        port = _port_caches(caches)
        got, _ = decoder.decode_step(
            params, pcfg, AxisCtx(), torch.from_numpy(toks), port,
            torch.from_numpy(lens), block_tables=torch.from_numpy(bt),
            decode_mask=torch.from_numpy(mask), kv_splits=S)
        _close(got[:2], want[:2])
        for i, c in enumerate(port):
            for k, v in c.items():
                if k in ("k_pages", "v_pages"):
                    _close(v[:, :NP], new[i][k][:, :NP])
                    continue
                for g, w, old in zip(v, new[i][k], caches[i][k]):
                    _close(g[:, :2], w[:, :2])
                    _close(g[:, 2], old[:, 2])


def test_dense_decode_on_prefill_caches_matches(twin):
    """The dense engine's path: prefill with ``return_cache`` (ring of 40,
    hymba's cut to its window), then two decode steps on those caches."""
    _, rcfg, pcfg, ref, params = twin
    toks = np.random.default_rng(5).integers(0, 64, (2, 24)).astype(np.int32)
    r_iso, p_iso = _isos(2)
    want = r_dec.prefill(ref, rcfg, RAxisCtx(), r_iso,
                         tokens=jnp.asarray(toks), return_cache=True,
                         cache_len=40)
    got = decoder.prefill(params, pcfg, AxisCtx(), p_iso,
                          tokens=torch.from_numpy(toks), return_cache=True,
                          cache_len=40)
    r_caches, p_caches = want["caches"], got["caches"]
    lens = np.asarray([24, 24], np.int32)
    for step in range(2):
        nt = np.random.default_rng(step).integers(0, 64, (2, 1)).astype(
            np.int32)
        w, r_caches = r_dec.decode_step(ref, rcfg, RAxisCtx(),
                                        jnp.asarray(nt), r_caches,
                                        jnp.asarray(lens + step))
        g, p_caches = decoder.decode_step(params, pcfg, AxisCtx(),
                                          torch.from_numpy(nt), p_caches,
                                          torch.from_numpy(lens + step))
        _close(g, w)


# ---------------------------------------------------------------------------
# init, bridge, sharding, state caches
# ---------------------------------------------------------------------------

def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(TWINS))
def test_init_dtypes_shapes_and_rank_shard(name):
    """bf16 weights with the reference's fp32 leaves (the SSM's a_log,
    dt_bias, d_skip; the mLSTM's gates and biases, the sLSTM's recurrent
    matrices and f_bias; the norms), the reference's leaf names, shapes and
    dtypes at tp=2, and each rank's init == its shard of the whole."""
    rcfg = TWINS[name]
    cfg = port_cfg(rcfg)
    whole = decoder.init_decoder_params(4, cfg, tp=2, dtype=torch.bfloat16,
                                        device="cpu")
    ref = jax.eval_shape(lambda: r_api.init_params(
        jax.random.PRNGKey(0), rcfg, tp=2, dtype=jnp.bfloat16))
    got = bridge.to_reference(whole)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
    fp32 = {path.rsplit("/", 1)[-1] for pos in whole["periods"]
            for path, t in _named_leaves(pos[0]) if t.dtype == torch.float32}
    assert fp32 == ({"scale", "a_log", "dt_bias", "d_skip"}
                    if name == "hybrid" else
                    {"scale", "w_i", "w_f", "f_bias", "i_bias", "r_i", "r_f",
                     "r_z", "r_o"})
    for rank in range(2):
        want = bridge.to_reference(decoder.shard_params(whole, rank, 2))
        got = bridge.to_reference(decoder.init_decoder_params(
            4, cfg, tp=2, dtype=torch.bfloat16, device="cpu", rank=rank))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_and_npz(twin, tmp_path, dtype):
    name, rcfg, _, _, _ = twin
    ref = r_api.init_params(jax.random.PRNGKey(3), rcfg, tp=1,
                            dtype=getattr(jnp, dtype))
    host = _host(ref)
    params = bridge.from_reference(host)
    layer = params["periods"][0][0]
    key = "ssm" if name == "hybrid" else "mlstm"
    assert layer[key]["a_log" if name == "hybrid" else "w_i"].dtype == \
        torch.float32
    path = tmp_path / "p.npz"
    bridge.save_npz(path, bridge.to_reference(params))
    for back in (bridge.to_reference(params), bridge.load_npz(path)):
        flat_a, tree_a = jax.tree_util.tree_flatten(host)
        flat_b, tree_b = jax.tree_util.tree_flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_shard_params_follows_decoder_param_specs(name, tp):
    """Leaf for leaf the reference's ``decoder_param_specs``: the SSM's
    inner-dim leaves split, its w_out by rows; the mLSTM's v path split on
    the feature dim and its w_out on dim 1; every sLSTM leaf (its w_z
    included) and the SSM's w_b/w_c replicated."""
    rcfg = TWINS[name]
    host = _host(r_api.init_params(jax.random.PRNGKey(0), rcfg, tp=tp,
                                   dtype=jnp.float32))
    specs = jax.tree_util.tree_leaves(r_dec.decoder_param_specs(host),
                                      is_leaf=lambda s: isinstance(s, P))
    leaves = jax.tree_util.tree_leaves(host)
    assert len(specs) == len(leaves)
    sharded = 0
    for rank in range(tp):
        local = jax.tree_util.tree_leaves(
            bridge.to_reference(bridge.shard_params(host, rank, tp)))
        for got, full, spec in zip(local, leaves, specs):
            want = full
            for axis, nm in enumerate(spec):
                if nm == "model":
                    n = full.shape[axis] // tp
                    want = np.take(full, np.arange(rank * n, (rank + 1) * n),
                                   axis=axis)
                    sharded += 1
            np.testing.assert_array_equal(got, want)
    # hybrid: table, head, wq/wk/wv/wo, mlp x3, ssm w_x/w_z/w_dt/conv_w/
    # dt_bias/d_skip/a_log/w_out; xlstm: table, head, 3 mLSTM positions x
    # (w_v, w_og, w_out)
    assert sharded == tp * (17 if name == "hybrid" else 11)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_state_caches_match_reference(name, tp):
    """``init_state_caches``: the reference's leaves, shapes, dtypes and
    values (mLSTM m at -1e30, sLSTM n at 1); ``local`` divides what
    ``cache_specs`` shards over the model axis."""
    rcfg = TWINS[name]
    cfg = port_cfg(rcfg)
    want = r_api.init_state_caches(rcfg, 3, tp=tp, dtype=jnp.bfloat16)
    specs = r_dec.cache_specs(jax.eval_shape(lambda: want), batch_axes=None,
                              shard_batch=False)
    got = api.init_state_caches(cfg, 3, tp, dtype=torch.bfloat16,
                                device="cpu")
    local = api.init_state_caches(cfg, 3, tp, dtype=torch.bfloat16,
                                  device="cpu", local=True)
    for g, gl, w, sp in zip(got, local, want, specs):
        assert set(g) == set(w)
        for k in g:
            assert type(g[k]).__name__ == type(w[k]).__name__
            for gt, lt, wt, s in zip(g[k], gl[k], w[k], sp[k]):
                np.testing.assert_array_equal(
                    bridge.to_numpy(gt).astype(np.float32),
                    np.asarray(wt).astype(np.float32))
                assert str(bridge.to_numpy(gt).dtype) == str(wt.dtype)
                shape = [n // tp if a == "model" else n
                         for n, a in zip(wt.shape, tuple(s) + (None,) * 9)]
                assert list(lt.shape) == shape


@pytest.mark.parametrize("name", RECURRENT)
def test_reduce_cfg_tiny_equals_reference(name):
    got = reduce_cfg(get_model_config(name), "tiny")
    want = r_reduce_cfg(r_get(name), "tiny")
    for f in dataclasses.fields(ModelConfig):
        if f.name != "ssm":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.ssm is None) == (want.ssm is None)
    if got.ssm is not None:
        assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert got.param_count() == want.param_count()
    assert got.sliding_window == (64 if name == "hymba-1.5b" else 0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("name", RECURRENT)
def test_serve_launcher_takes_recurrent_arch(name, paged, capsys):
    from repro_torch.launch import serve
    args = ["--arch", name, "--preset", "tiny", "--device", "cpu",
            "--dtype", "float32", "--requests", "2", "--prompt-len", "40",
            "--max-new", "3", "--prefill-budget", "16"]
    assert serve.main(args + (["--paged"] if paged else [])) == 0
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "completed=2" in out
