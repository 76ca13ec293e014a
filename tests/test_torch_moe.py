"""The port's MoE family (``layers/moe.py``, the ``attn_moe`` block, the
expert-parallel sharding rule) against the JAX package, on the CPU, on
numpy inputs from a seed, fp32 within atol 1e-5 and bf16 within 2e-2 +
2e-2 rel:

  * ``route``, ``capacity`` and ``moe_partial`` on the ``tiny_moe`` shape,
    with and without the shared expert, at capacity factor 8.0 (nothing
    drops), 1.25 and 0.5 (at least one assignment dropped);
  * 5 experts padded to 8 at tp=4: the padding experts never picked, each
    rank's partial (its ``expert_offset``, its shard of the experts and of
    the shared expert) equal to the reference's, the four summing to the
    whole;
  * the decoder on bridged weights: prefill over 1 and 2 ISO chunks
    (logits and ``moe_aux``), a resumed paged prefill, paged decode at K 1
    and 5;
  * init (router fp32 in a bf16 model, rank shard == shard of the whole),
    the bridge round trip and ``save_npz``/``load_npz`` of ``moe`` subtrees,
    ``shard_params`` against ``decoder_param_specs`` for the 3-D expert
    leaves and the shared expert, ``reduce_cfg`` tiny against the
    reference's, and the launcher on each tiny twin with and without
    ``--paged``;
  * no closure body of an MoE engine reads a tensor back to the host (the
    MoE stage runs inside the CUDA graphs).

The engines (paged, dense, disaggregated) are in
tests/test_torch_moe_serving.py, tensor parallelism over gloo in
tests/test_torch_tp.py."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from conftest import iso_cfg, tiny_moe  # noqa: E402
from repro.config import MoEConfig as RMoEConfig  # noqa: E402
from repro.config import get_model_config as r_get  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.launch.train import reduce_cfg as r_reduce_cfg  # noqa: E402
from repro.layers import moe as r_moe  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models import decoder as r_dec  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import ISOConfig, ModelConfig, MoEConfig, \
    get_model_config  # noqa: E402
from repro_torch.configs import MOE  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch.serve import reduce_cfg  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
D = 64
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return ModelConfig(**kw)


def _mcfg(cf, shared, experts=4):
    return RMoEConfig(num_experts=experts, top_k=2, d_ff_expert=64,
                      capacity_factor=cf,
                      shared_expert_d_ff=32 if shared else 0)


def _weights(mcfg, tp, dtype, seed=0):
    """Reference MoE weights (numpy) and the port's copy."""
    ref = r_moe.init_moe(jax.random.PRNGKey(seed), D, mcfg, tp, 2,
                         dtype=getattr(jnp, dtype))
    host = jax.tree_util.tree_map(np.asarray, ref)
    return host, bridge._map(host, bridge.to_torch)


def _x(dtype, shape=(2, 24, D), seed=1):
    """Tokens that share a common component, so the router's load is uneven
    (as real hidden states' is) and capacity 1.25 drops."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + 2.0 * rng.standard_normal(shape[-1])
         ).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    want = np.array(jnp.asarray(want).astype(jnp.float32))
    torch.testing.assert_close(got.float(), torch.from_numpy(want),
                               **TOL[dtype])


def dropped(idx: np.ndarray, C: int, e_pad: int) -> int:
    """Assignments past the capacity: sum over experts of max(0, load - C)."""
    load = np.bincount(idx.reshape(-1), minlength=e_pad)
    return int(np.maximum(load - C, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "routed"])
def test_moe_layer_matches_reference(shared, cf, dtype):
    mcfg = _mcfg(cf, shared)
    host, p = _weights(mcfg, 1, dtype)
    rx, x = _x(dtype)
    T = x.shape[0] * x.shape[1]
    w_r, idx_r, aux_r = r_moe.route(host["router"], rx.reshape(T, D), mcfg, 4)
    w, idx, aux = moe.route(p["router"], x.reshape(T, D), mcfg, 4)
    assert torch.equal(idx, torch.from_numpy(np.array(idx_r)).long())
    _close(w, w_r, "float32")
    _close(aux, aux_r, "float32")
    C = moe.capacity(T, mcfg, 4)
    assert C == r_moe.capacity(T, mcfg, 4)
    n_drop = dropped(np.asarray(idx_r), C, 4)
    assert (n_drop == 0) == (cf == 8.0), (cf, C, n_drop)
    y_r, a_r = r_moe.moe_partial(host, rx, mcfg, tp=1, expert_offset=0)
    y, a = moe.moe_partial(p, x, mcfg, tp=1, expert_offset=0)
    assert y.dtype == x.dtype and y.shape == x.shape
    _close(y, y_r, dtype)
    _close(a, a_r, "float32")


@pytest.mark.parametrize("tokens", [1, 3, 8, 40, 97, 256, 1000])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(tokens, cf):
    for name in MOE:
        m = get_model_config(name).moe
        mc = dataclasses.replace(m, capacity_factor=cf)
        rc = dataclasses.replace(r_get(name).moe, capacity_factor=cf)
        for tp in (1, 4, 16):
            assert moe.capacity(tokens, mc, m.padded_experts(tp)) == \
                r_moe.capacity(tokens, rc, rc.padded_experts(tp))


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_padded_experts_shard_sum_to_whole(cf):
    """5 experts padded to 8 at tp=4: two experts a rank; the padding
    experts (5..7) are never picked; each rank's partial equals the
    reference's at its offset, and the four sum to the tp=1 call on the
    same (padded) weights; the aux is aux/tp on every rank."""
    mcfg = _mcfg(cf, True, experts=5)
    tp, e_pad = 4, 8
    host, p = _weights(mcfg, tp, "float32", seed=2)
    assert p["router"].shape == (D, e_pad) and p["w_up"].shape[0] == e_pad
    rx, x = _x("float32", seed=3)
    _, idx, _ = moe.route(p["router"], x.reshape(-1, D), mcfg, e_pad)
    assert int(idx.max()) < 5
    whole, aux = moe.moe_partial(p, x, mcfg, tp=1, expert_offset=0)
    total = torch.zeros_like(whole)
    for rank in range(tp):
        local = decoder._shard_tree(p, rank, tp)
        assert local["w_up"].shape[0] == 2 and local["router"].shape[1] == 8
        assert local["shared"]["w_up"].shape == (D, 32 // tp)
        r_local = bridge._map(local, bridge.to_numpy)
        want, r_aux = r_moe.moe_partial(r_local, rx, mcfg, tp=tp,
                                        expert_offset=rank * 2)
        got, a = moe.moe_partial(local, x, mcfg, tp=tp,
                                 expert_offset=rank * 2)
        _close(got, want, "float32")
        _close(a, r_aux, "float32")
        torch.testing.assert_close(a * tp, aux, atol=1e-6, rtol=1e-6)
        total = total + got
    torch.testing.assert_close(total, whole, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the decoder on bridged weights
# ---------------------------------------------------------------------------

REF_CFG = tiny_moe(vocab_size=64)
PORT_CFG = port_cfg(REF_CFG)
PS, NP = 8, 12


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _pools(rng):
    shape = (REF_CFG.num_layers, NP + 1, PS, REF_CFG.num_kv_heads,
             REF_CFG.resolved_head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("chunks", [1, 2])
def test_prefill_logits_and_aux_match(weights, chunks):
    ref, params = weights
    toks = np.random.default_rng(0).integers(0, 64, (2, 24)).astype(np.int32)
    r_iso = iso_cfg(chunks, min_chunk_tokens=8, chunk_align=8)
    p_iso = ISOConfig(enabled=True, num_chunks=chunks, min_chunk_tokens=8,
                      chunk_align=8)
    want = r_dec.prefill(ref, REF_CFG, RAxisCtx(), r_iso,
                         tokens=jnp.asarray(toks))
    got = decoder.prefill(params, PORT_CFG, AxisCtx(), p_iso,
                          tokens=torch.from_numpy(toks))
    assert got["num_chunks"] == want["num_chunks"] == chunks
    _close(got["logits_local"], want["logits_local"], "float32")
    _close(got["moe_aux"], want["moe_aux"], "float32")
    assert float(got["moe_aux"]) > 0


def test_resumed_paged_prefill_matches(weights):
    """A 16-token grant (13 real, 3 bucket pad) resuming at position 21 over
    a page-resident prefix, over 2 ISO chunks."""
    ref, params = weights
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng)
    bt = np.asarray([[5, 2, 9, 0, -1, -1]], np.int32)
    toks = rng.integers(0, 64, (1, 16)).astype(np.int32)
    kw = dict(pos_offset=21, valid_len=13)
    want = r_dec.prefill(
        ref, REF_CFG, RAxisCtx(), REF_ISO, tokens=jnp.asarray(toks),
        prefix_caches=({"k_pages": jnp.asarray(kp),
                        "v_pages": jnp.asarray(vp)},),
        block_tables=jnp.asarray(bt),
        prefix_lens=jnp.asarray([21], jnp.int32), **kw)
    got = decoder.prefill(
        params, PORT_CFG, AxisCtx(), PORT_ISO, tokens=torch.from_numpy(toks),
        prefix_caches=({"k_pages": torch.from_numpy(kp),
                        "v_pages": torch.from_numpy(vp)},),
        block_tables=torch.from_numpy(bt),
        prefix_lens=torch.tensor([21], dtype=torch.int32), **kw)
    assert got["num_chunks"] == 2
    _close(got["logits_local"][:, :13], want["logits_local"][:, :13],
           "float32")
    _close(got["moe_aux"], want["moe_aux"], "float32")


@pytest.mark.parametrize("K", [1, 5])
def test_paged_decode_step_matches(weights, K):
    """Batched decode over block tables (one inactive slot), split-KV S=4
    in the reference against S=1 and S=4 in the port; logits and the pools'
    in-place update match."""
    ref, params = weights
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    bt = np.asarray([[3, 7, 1, 6], [4, 10, -1, -1], [-1, -1, -1, -1]],
                    np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    mask = np.asarray([True, True, False])
    toks = rng.integers(0, 64, (3, K)).astype(np.int32)
    want, caches = r_dec.decode_step(
        ref, REF_CFG, RAxisCtx(), jnp.asarray(toks),
        ({"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},),
        jnp.asarray(lens), block_tables=jnp.asarray(bt),
        decode_mask=jnp.asarray(mask), kv_splits=4)
    for S in (1, 4):
        pools = {"k_pages": torch.from_numpy(kp.copy()),
                 "v_pages": torch.from_numpy(vp.copy())}
        got, _ = decoder.decode_step(
            params, PORT_CFG, AxisCtx(), torch.from_numpy(toks), (pools,),
            torch.from_numpy(lens), block_tables=torch.from_numpy(bt),
            decode_mask=torch.from_numpy(mask), kv_splits=S)
        assert got.shape[:2] == (3, K)
        _close(got[:2], want[:2], "float32")
        for name in ("k_pages", "v_pages"):
            _close(pools[name][:, :NP], caches[0][name][:, :NP], "float32")


# ---------------------------------------------------------------------------
# init, bridge, sharding
# ---------------------------------------------------------------------------

def test_init_router_fp32_and_rank_shard_equals_shard_of_whole():
    cfg = port_cfg(tiny_moe(moe=RMoEConfig(num_experts=5, top_k=2,
                                           d_ff_expert=64,
                                           shared_expert_d_ff=32)))
    whole = decoder.init_decoder_params(4, cfg, tp=4, dtype=torch.bfloat16,
                                        device="cpu")
    m = whole["periods"][0][0]["moe"]
    assert m["router"].dtype == torch.float32 and m["router"].shape == (64, 8)
    assert m["w_up"].dtype == torch.bfloat16
    assert (m["w_up"].shape, m["w_down"].shape) == ((8, 64, 64), (8, 64, 64))
    assert m["shared"]["w_down"].shape == (32, 64)
    assert "mlp" not in whole["periods"][0][0]
    for rank in range(4):
        want = bridge.to_reference(decoder.shard_params(whole, rank, 4))
        got = bridge.to_reference(decoder.init_decoder_params(
            4, cfg, tp=4, dtype=torch.bfloat16, device="cpu", rank=rank))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_and_npz(tmp_path, dtype):
    ref = r_api.init_params(jax.random.PRNGKey(3), REF_CFG, tp=1,
                            dtype=getattr(jnp, dtype))
    host = jax.tree_util.tree_map(np.asarray, ref)
    params = bridge.from_reference(host)
    m = params["periods"][0][1]["moe"]
    assert m["w_up"].shape == (4, 64, 64) and m["router"].shape == (64, 4)
    assert m["router"].dtype == torch.float32
    assert m["shared"]["w_gate"].shape == (64, 32)
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
def test_shard_params_follows_decoder_param_specs(tp):
    """The 3-D expert leaves split on the expert axis, the shared expert's
    2-D leaves as the dense MLP's, the router replicated: leaf for leaf the
    reference's ``decoder_param_specs``."""
    cfg = tiny_moe(vocab_size=64, moe=RMoEConfig(
        num_experts=5, top_k=2, d_ff_expert=64, shared_expert_d_ff=32))
    host = jax.tree_util.tree_map(np.asarray, r_api.init_params(
        jax.random.PRNGKey(0), cfg, tp=tp, dtype=jnp.float32))
    specs = jax.tree_util.tree_leaves(r_dec.decoder_param_specs(host),
                                      is_leaf=lambda s: isinstance(s, P))
    leaves = jax.tree_util.tree_leaves(host)
    assert len(specs) == len(leaves)
    sharded = 0
    for rank in range(tp):
        local = jax.tree_util.tree_leaves(
            bridge.to_reference(bridge.shard_params(host, rank, tp)))
        assert len(local) == len(leaves)
        for got, full, spec in zip(local, leaves, specs):
            want = full
            for axis, name in enumerate(spec):
                if name == "model":
                    n = full.shape[axis] // tp
                    want = np.take(full, np.arange(rank * n, (rank + 1) * n),
                                   axis=axis)
                    sharded += 1
            np.testing.assert_array_equal(got, want)
    # table, head, wq/wk/wv/wo, 3 expert stacks, 3 shared-expert leaves
    assert sharded == tp * 12


@pytest.mark.parametrize("name", MOE)
def test_reduce_cfg_tiny_equals_reference(name):
    got = reduce_cfg(get_model_config(name), "tiny")
    want = r_reduce_cfg(r_get(name), "tiny")
    for f in dataclasses.fields(ModelConfig):
        if f.name != "moe":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert (got.moe.num_experts, got.moe.top_k) == (4, 2)
    assert got.param_count() == want.param_count()
    assert got.param_count(active_only=True) == \
        want.param_count(active_only=True)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("name", MOE)
def test_serve_launcher_takes_moe_arch(name, paged, capsys):
    from repro_torch.launch import serve
    args = ["--arch", name, "--preset", "tiny", "--device", "cpu",
            "--dtype", "float32", "--requests", "2", "--prompt-len", "40",
            "--max-new", "3", "--prefill-budget", "16"]
    assert serve.main(args + (["--paged"] if paged else [])) == 0
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "completed=2" in out


class _NoHostReads(TorchFunctionMode):
    """Raises on every way a tensor's value reaches the host, and on a
    tensor made from host data: a CUDA graph would bake the value read at
    capture into every replay (as tests/test_torch_graphs.py's guard)."""
    BANNED = {"item", "__int__", "__float__", "__bool__", "__index__",
              "cpu", "tolist", "numpy", "tensor", "as_tensor",
              "from_numpy", "nonzero"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.BANNED:
            raise AssertionError(f"host read on the captured path: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", ["fresh", "resumed", "packed", "decode",
                                   "verify_split"])
def test_moe_closure_bodies_read_nothing_back(weights, which):
    """The MoE stage runs inside the engine's CUDA graphs: no closure body
    of an MoE engine reads a tensor back to the host."""
    from repro_torch.config import Config, ParallelConfig, ServingConfig
    from repro_torch.serving import PagedEngine
    _, params = weights
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO,
                             serving=ServingConfig(page_size=8, max_batch=3,
                                                   max_len=64)),
                      params, device="cpu")
    rows = np.asarray([[1, 2, 3, -1, -1, -1, -1, -1],
                       [4, 5, -1, -1, -1, -1, -1, -1],
                       [-1] * 8], np.int32)
    if which in ("fresh", "resumed"):
        fn = eng._get_prefill(16, which == "resumed")
        fn.stage(tokens=np.ones((1, 16), np.int32), bt=rows[:1],
                 start=5 if which == "resumed" else 0, n_real=13)
    elif which == "packed":
        fn = eng._get_prefill_batched(16, 3, False)
        fn.stage(tokens=np.ones((3, 16), np.int32), bt=rows,
                 starts=np.asarray([5, 0, 0], np.int32),
                 n_reals=np.asarray([13, 9, 0], np.int32))
    else:
        K, S = (1, 1) if which == "decode" else (3, 2)
        fn = eng._get_decode(K, S)
        fn.stage(toks=np.ones((3, K), np.int32),
                 lengths=np.asarray([20, 9, 0], np.int32), bt=rows,
                 mask=np.asarray([True, True, False]))
    with _NoHostReads():
        out = fn()
    assert torch.isfinite(out).all()
