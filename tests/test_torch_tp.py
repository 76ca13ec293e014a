"""Tensor-parallel serving in the port against the JAX reference, on gloo
ranks on the CPU (``launch/mesh.spawn``), at the ``tiny_dense`` size in fp32.

  * ``shard_params`` cuts params built at tp=N as the reference's
    ``decoder_param_specs`` does;
  * ``quantized_psum`` at tp=2 and tp=4 against the reference's function
    run under ``jax.vmap`` over a named axis;
  * the ISO issue order: every reduce is started as soon as its partial
    exists and completed after the next unit's compute (prefill chunks,
    decode batch halves), or after the KV scatter (cross-block decode);
  * ``PagedEngine`` at tp=2 and tp=4 (tp=4 replicates the 2 kv heads) under
    the sequential, batch-split and cross-block decode schedules, with
    resumed grants, split-KV decode and a batch draining to one request:
    greedy tokens EQUAL to the reference ``PagedEngine(mesh=None)`` on the
    same (tp=1) model, and equal on every rank;
  * at tp=2, packed grants, prefix sharing and a spec_k=2 verify window
    together give the tp=1 port engine's tokens and counters;
  * MoE twins at tp=2 and tp=4 (expert parallelism: 4 experts split 2 and
    1 a rank, 5 padded to 6 and 8 at capacity 1.25): greedy tokens on every
    rank equal the reference ``PagedEngine(mesh=None)`` on the same
    tp-built params;
  * the recurrent twins of the reference's tests/test_multidevice.py:55-60
    (hymba's ``hybrid`` block at 8/2 heads with window 16, and 3 mLSTM : 1
    sLSTM) at tp=2: the SSM's inner dim and the mLSTM's v dim split over
    the ranks with their states, the sLSTM replicated and not reduced;
    greedy tokens on every rank, under batch-split and sequential decode,
    equal the reference ``PagedEngine(mesh=None)`` on the same tp-built
    params.

One spawn per tp degree runs every rank-side case: the parent writes the
reference's tp=N params to ``tmp_path`` as ``.npz``; the ranks load and
shard them (``launch/serve.serve_rank``) and hand their results back.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_moe  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ModelConfig as RModelConfig  # noqa: E402
from repro.config import MoEConfig as RMoEConfig  # noqa: E402
from repro.config import SSMConfig as RSSMConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.core.quantized_collectives import \
    quantized_psum as r_quantized_psum  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.models.decoder import decoder_param_specs  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, MoEConfig, \
    ParallelConfig, SSMConfig, ServingConfig  # noqa: E402
from repro_torch.core import iso  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.core.quantized_collectives import \
    quantized_psum  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import serve_rank  # noqa: E402
from repro_torch.models import blocks, decoder  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
REF_ISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
SCHEDULES = ("sequential", "batch_split", "cross_block")
# (name, prompt lengths, rng seed, new tokens, serving kwargs): 4 requests
# over 2 slots, so the decode batch drains to one request at the end
CASES = [
    # a 16-token budget: long prompts resume across grants (paged prefill)
    ("mixed_resumed", (70, 12, 33, 7), 3, 5,
     dict(prefill_token_budget=16, page_size=8, max_len=160, max_batch=2)),
    # split-KV decode forced to 4 spans
    ("splits4", (70, 12, 33, 7), 3, 5,
     dict(prefill_token_budget=64, page_size=8, max_len=160, max_batch=2,
          decode_kv_splits=4)),
]
# quantized_psum inputs: (shape per rank, seed)
PSUM_SHAPES = [((5, 64), 0), ((2, 3, 32), 1)]


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 64, n).astype(np.int32) for n in lengths]


# the reference's default serving features together at tp=2: packed
# grants, prefix sharing (two prompts open with a 24-token head) and a
# spec_k=2 verify window, under the default batch-split schedule
FEATURES = dict(prefill_token_budget=64, page_size=8, max_len=160,
                max_batch=4, prefix_sharing=True, prefill_batching=True,
                spec_k=2)


def _feature_prompts():
    rng = np.random.default_rng(5)
    head = rng.integers(2, 64, 24).astype(np.int32)
    rep = np.tile(rng.integers(2, 64, 6).astype(np.int32), 6)[:33]
    return [rep, np.concatenate([head, rng.integers(2, 64, 9)]).astype(
        np.int32), np.concatenate([head, rng.integers(2, 64, 4)]).astype(
        np.int32), rng.integers(2, 64, 17).astype(np.int32)]


def _variants(tp):
    """Rank-side engine runs, keyed by (case, schedule, quantized)."""
    keys, variants = [], []
    if tp == 2:
        keys.append(("features", "auto", False))
        variants.append(dict(prompts=_feature_prompts(), max_new=8,
                             serving=dict(FEATURES)))
    for name, lengths, seed, new, sv in CASES:
        for sched in SCHEDULES:
            keys.append((name, sched, False))
            variants.append(dict(prompts=_prompts(lengths, seed),
                                 max_new=new,
                                 serving=dict(sv, decode_schedule=sched)))
    name, lengths, seed, new, sv = CASES[0]
    keys.append((name, "auto", True))
    variants.append(dict(prompts=_prompts(lengths, seed), max_new=new,
                         serving=dict(sv), iso=dict(quantized_comm=True)))
    return keys, variants


def _psum_inputs(tp):
    return [np.random.default_rng(seed).standard_normal((tp, *shape))
            .astype(np.float32) * 3 for shape, seed in PSUM_SHAPES]


def _rank_job(group, params_npz, config, variants, psum_inputs):
    """Body of every rank: the quantized reduce of this rank's slice of each
    input, then the engine runs."""
    psum = [quantized_psum(torch.from_numpy(x[group.rank].copy()), None,
                           group.tp).numpy() for x in psum_inputs]
    return dict(psum=psum, serve=serve_rank(group, config, variants,
                                            params_npz=params_npz))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """tp -> (per-rank results, variant keys), one spawn per degree."""
    cache = {}

    def get(tp):
        if tp not in cache:
            ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=tp,
                                    dtype=jnp.float32)
            path = tmp_path_factory.mktemp(f"tp{tp}") / "params.npz"
            bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
            keys, variants = _variants(tp)
            config = Config(model=PORT_CFG,
                            parallel=ParallelConfig(data=1, model=tp),
                            iso=PORT_ISO,
                            serving=ServingConfig(prefix_sharing=False,
                                                  prefill_batching=False))
            res = mesh.spawn(_rank_job, tp, args=(str(path), config, variants,
                                                  _psum_inputs(tp)),
                             device="cpu", timeout_s=300)
            cache[tp] = (res, keys)
        return cache[tp]
    return get


@pytest.fixture(scope="module")
def reference_tokens():
    """case name -> the reference PagedEngine's greedy tokens on the tp=1
    model (mesh=None: sequential decode, identity collectives)."""
    params = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                               dtype=jnp.float32)
    out = {}
    for name, lengths, seed, new, sv in CASES:
        config = RConfig(model=REF_CFG, parallel=RParallel(data=1, model=1),
                         iso=REF_ISO,
                         serving=RServing(prefix_sharing=False,
                                          prefill_batching=False, **sv))
        eng = RPagedEngine(config, params)
        rids = [eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
            max_new_tokens=new, eos_id=-1))) for p in _prompts(lengths, seed)]
        res = eng.run_until_complete()
        out[name] = ([res[r] for r in rids], dict(eng.metrics))
    return out


# ---------------------------------------------------------------------------
# sharding and the KV pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_follows_decoder_param_specs(tp):
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=tp,
                            dtype=jnp.float32)
    host = jax.tree_util.tree_map(np.asarray, ref)
    specs = jax.tree_util.tree_leaves(decoder_param_specs(host),
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
    assert sharded == tp * 9          # table, head + 7 leaves of the layer


def test_port_init_rank_shard_equals_shard_of_whole():
    whole = decoder.init_decoder_params(5, PORT_CFG, tp=2,
                                        dtype=torch.float32, device="cpu")
    for rank in range(2):
        want = jax.tree_util.tree_leaves(bridge.to_reference(
            bridge.shard_params(whole, rank, 2)))
        got = jax.tree_util.tree_leaves(bridge.to_reference(
            decoder.init_decoder_params(5, PORT_CFG, tp=2,
                                        dtype=torch.float32, device="cpu",
                                        rank=rank)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tp,local_heads", [(1, 2), (2, 1), (4, 1)])
def test_kv_pool_holds_local_heads(tp, local_heads):
    """Each rank's pool holds hkv_eff // tp heads (tp=4 replicates the 2
    logical kv heads to 4 slots, one per rank)."""
    kv = PagedKVCache(PORT_CFG, num_pages=3, page_size=8, tp=tp,
                      dtype=torch.float32, device="cpu")
    assert kv.k[0].shape == (2, 4, 8, local_heads, 16)


def test_rank_device_and_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.rank_device("cpu", 1, 4) == (torch.device("cpu"), "gloo")
    assert mesh.rank_device("cuda", 0, 1) == (torch.device("cuda", 0), "nccl")
    with pytest.raises(ValueError, match="needs 2 cards"):
        mesh.rank_device("cuda", 0, 2)
    with pytest.raises(ValueError, match="NCCL refuses"):
        mesh.rank_device("cuda:0", 1, 2, "nccl")
    # one shared card only when asked for by device index
    assert mesh.rank_device("cuda:0", 1, 2) == (torch.device("cuda", 0),
                                                 "gloo")
    with pytest.raises(ValueError, match="gloo"):
        mesh.rank_device("cpu", 0, 2, "nccl")


# ---------------------------------------------------------------------------
# issue order of the collectives
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Log compute units, reduce starts/waits and KV scatters in the order
    the ISO drivers issue them."""
    events = []
    real_start, real_wait = iso.psum_start, iso.psum_wait
    tags = []

    def start(partial, ctx):
        pend = real_start(partial, ctx)
        pend.tag = len(tags)
        tags.append(pend.tag)
        events.append(("start", pend.tag))
        return pend

    def wait(pend, outs=()):
        events.append(("wait", pend.tag))
        return real_wait(pend, outs)

    def stage(fn):
        def run(p, x, start_pos, seq_state, sctx, cache=None):
            events.append(("compute", fn.__name__, x.shape[0]))
            return fn(p, x, start_pos, seq_state, sctx, cache)
        return run

    real_apply = iso._apply_decode_cache_update

    def apply(cache, extras, sctx):
        if "kv" in extras:
            events.append(("scatter",))
        return real_apply(cache, extras, sctx)

    monkeypatch.setattr(iso, "psum_start", start)
    monkeypatch.setattr(iso, "psum_wait", wait)
    monkeypatch.setattr(iso, "psum_now",
                        lambda partial, ctx: wait(start(partial, ctx))[0])
    monkeypatch.setattr(iso, "_apply_decode_cache_update", apply)
    monkeypatch.setitem(blocks.BLOCK_STAGES, "attn_mlp", tuple(
        (stage(fn), r) for fn, r in blocks.BLOCK_STAGES["attn_mlp"]))
    return events


def _windows(events):
    """reduce tag -> the events between its start and its wait."""
    pos = {}
    for i, e in enumerate(events):
        if e[0] in ("start", "wait"):
            pos.setdefault(e[1], []).append(i)
    assert all(len(v) == 2 for v in pos.values()), pos
    return {t: events[a + 1:b] for t, (a, b) in pos.items()}


def _tiny_params():
    return decoder.init_decoder_params(0, PORT_CFG, dtype=torch.float32,
                                       device="cpu")


def test_prefill_starts_each_reduce_before_the_next_chunks_compute(
        monkeypatch):
    """Figure 1(d): the reduce of unit (s, c) is issued right after its
    compute, and completes only after unit (s, c+1)'s compute: one compute
    unit inside every window but the trailing one."""
    events = _record(monkeypatch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (1, 32)).astype(np.int32))
    out = decoder.prefill(_tiny_params(), PORT_CFG, AxisCtx(), PORT_ISO,
                          tokens=toks)
    assert out["num_chunks"] == 2
    windows = _windows(events)
    n_units = 2 * 2 * PORT_CFG.num_layers         # stages x chunks x layers
    assert len(windows) == n_units
    for i, e in enumerate(events):                # started at once
        if e[0] == "start":
            assert events[i - 1][0] == "compute"
    for tag in range(n_units - 1):
        computes = [e for e in windows[tag] if e[0] == "compute"]
        assert len(computes) == 1, (tag, windows[tag])
    # the trailing flush has nothing to hide behind
    assert not [e for e in windows[n_units - 1] if e[0] == "compute"]


def _decode_inputs():
    rng = np.random.default_rng(2)
    shape = (PORT_CFG.num_layers, 13, 8, 2, 16)
    pools = {"k_pages": torch.from_numpy(rng.standard_normal(shape)
                                         .astype(np.float32)),
             "v_pages": torch.from_numpy(rng.standard_normal(shape)
                                         .astype(np.float32))}
    bt = torch.tensor([[3, 7, 1, -1], [4, 10, -1, -1], [2, -1, -1, -1],
                       [5, 6, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([20, 9, 3, 12], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True])
    toks = torch.from_numpy(rng.integers(0, 64, (4, 1)).astype(np.int32))
    return toks, (pools,), lens, bt, mask


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_decode_schedules_issue_order_and_numbers(monkeypatch, schedule):
    """batch_split: each half's reduce runs beside the other half's compute;
    cross_block: each reduce's window holds its stage's KV scatter;
    sequential: no window.  All three give the same logits and pools."""
    params = _tiny_params()
    base_in = _decode_inputs()
    want, (want_pools,) = decoder.decode_step(
        params, PORT_CFG, AxisCtx(), *base_in[:3], block_tables=base_in[3],
        decode_mask=base_in[4])
    events = _record(monkeypatch)
    toks, caches, lens, bt, mask = _decode_inputs()
    got, _ = decoder.decode_step(params, PORT_CFG, AxisCtx(), toks, caches,
                                 lens, block_tables=bt, decode_mask=mask,
                                 schedule=schedule)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for k in ("k_pages", "v_pages"):
        torch.testing.assert_close(caches[0][k], want_pools[k])
    windows = list(_windows(events).values())
    n_stages = 2 * PORT_CFG.num_layers
    if schedule == "sequential":
        assert all(w == [] for w in windows) and len(windows) == n_stages
    elif schedule == "cross_block":
        assert len(windows) == n_stages
        # attention stages carry their scatter inside the window
        assert [w for w in windows if w] == [[("scatter",)]] * \
            PORT_CFG.num_layers
    else:
        assert len(windows) == 2 * n_stages
        for w in windows[:-1]:                    # the other half's unit
            computes = [e for e in w if e[0] == "compute"]
            assert len(computes) == 1 and computes[0][2] == 2, w
        assert not [e for e in windows[-1] if e[0] == "compute"]


# ---------------------------------------------------------------------------
# ranks: quantized reduce and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_psum_matches_reference(tp_runs, tp):
    """Every rank's int8 reduce equals the reference's within one step of
    the output scale (amax/127 of the reduced slice): the fp32 sum of the
    tp dequantized shards may round in another order and re-quantize one
    step apart."""
    results, _ = tp_runs(tp)
    for i, x in enumerate(_psum_inputs(tp)):
        want = np.asarray(jax.vmap(lambda a: r_quantized_psum(a, "model", tp),
                                   axis_name="model")(jnp.asarray(x)))[0]
        # per (row, shard): the amax of the reduced slice over 127
        blocks = np.abs(want).reshape(*want.shape[:-1], tp, -1)
        step = np.broadcast_to(blocks.max(axis=-1, keepdims=True) / 127.0,
                               blocks.shape).reshape(want.shape)
        for r in range(tp):
            got = results[r]["psum"][i]
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.all(np.abs(got - want) <= step * 1.001 + 1e-7), \
                (tp, i, r, np.abs(got - want).max())
        # the sum really is a reduce: far from any single rank's input
        assert np.abs(want - x[0]).max() > 1.0


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_tokens_equal_reference(tp_runs, reference_tokens, tp,
                                          case, schedule):
    results, keys = tp_runs(tp)
    idx = keys.index((case, schedule, False))
    want, ref_m = reference_tokens[case]
    runs = [results[r]["serve"][idx] for r in range(tp)]
    for r, run in enumerate(runs):
        assert run["tokens"] == want, (r, run["tokens"], want)
    m = runs[0]["metrics"]
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "preemptions", "prefill_pad_tokens"):
        assert m[k] == ref_m[k], (k, m[k], ref_m[k])
    assert m["resumed_grants"] > 0
    steps = runs[0]["schedule_steps"]
    if schedule == "batch_split":
        # two decoding requests overlap; the drained batch falls back
        assert steps["batch_split"] > 0 and steps["sequential"] > 0
    else:
        assert set(steps) == {schedule}
    launches = runs[0]["launches"]
    assert all(n == 0 for n in launches.values())   # CPU: plain versions


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_quantized_comm_runs_on_every_rank(tp_runs, tp):
    """int8 collectives change the numbers, so there is no token equality
    with the reference: every request completes, all ranks agree, and the
    engine picks batch_split under TP (``auto``)."""
    results, keys = tp_runs(tp)
    idx = keys.index((CASES[0][0], "auto", True))
    runs = [results[r]["serve"][idx] for r in range(tp)]
    assert runs[0]["decode_schedule"] == "batch_split"
    assert all(len(t) == CASES[0][3] for t in runs[0]["tokens"])
    assert all(run["tokens"] == runs[0]["tokens"] for run in runs)
    assert runs[0]["rows_checked"] == len(CASES[0][1]) * CASES[0][3]


def test_tp2_serving_features_equal_tp1(tp_runs):
    """Packed grants, prefix sharing and speculation together at tp=2 give
    the tp=1 port engine's tokens and counters on every rank, and that tp=1
    run gives the reference engine's."""
    from repro_torch.serving import PagedEngine, Request
    from repro_torch.serving.requests import SamplingParams
    results, keys = tp_runs(2)
    idx = keys.index(("features", "auto", False))
    runs = [results[r]["serve"][idx] for r in range(2)]
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    r_eng = RPagedEngine(RConfig(model=REF_CFG,
                                 parallel=RParallel(data=1, model=1),
                                 iso=REF_ISO, serving=RServing(**FEATURES)),
                         ref)
    r_rids = [r_eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=8, eos_id=-1))) for p in _feature_prompts()]
    r_out = r_eng.run_until_complete()
    eng = PagedEngine(Config(model=PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO, serving=ServingConfig(**FEATURES)),
                      bridge.from_reference(
                          jax.tree_util.tree_map(np.asarray, ref),
                          device="cpu"), device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=8, eos_id=-1))) for p in _feature_prompts()]
    out = eng.run_until_complete()
    want = [out[r] for r in rids]
    assert want == [r_out[r] for r in r_rids]
    for k in ("prefill_calls", "prefill_pad_rows", "prefix_shared_tokens",
              "cow_copies", "spec_calls", "spec_tokens", "decode_calls"):
        assert eng.metrics[k] == r_eng.metrics[k], k
    for run in runs:
        assert run["tokens"] == want
        assert run["decode_schedule"] == "batch_split"
    m = runs[0]["metrics"]
    for k in ("prefill_calls", "prefill_pad_rows", "prefix_shared_tokens",
              "cow_copies", "spec_calls", "spec_tokens", "decode_calls"):
        assert m[k] == eng.metrics[k], k
    assert m["prefix_shared_tokens"] > 0 and m["spec_calls"] > 0
    assert m["prefill_calls"] < m["prefill_grants"]


def test_serve_launcher_tp2_on_cpu(capsys):
    """``--tp 2 --device cpu`` spawns two gloo ranks; rank 0 reports."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3-8b", "--preset", "tiny", "--paged",
                       "--device", "cpu", "--dtype", "float32", "--tp", "2",
                       "--requests", "3", "--prompt-len", "40",
                       "--max-new", "4", "--prefill-budget", "16"]) == 0
    out = capsys.readouterr().out
    assert "tp=2" in out and "decode_schedule=batch_split" in out
    assert "completed=3" in out and "resumed=" in out


# ---------------------------------------------------------------------------
# an MHA twin at tp=4: 6 kv heads in 8 slots, two of them zero pad
# ---------------------------------------------------------------------------

MHA_CFG = tiny_dense(d_model=96, num_heads=6, num_kv_heads=6, qk_norm=False,
                     rope_theta=1e4, vocab_size=64)
MHA_PORT_CFG = ModelConfig(**{f: getattr(MHA_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm", "rope_theta")})


def _mha_rank_job(group, params_npz, config, variants):
    """Serve each variant, recording every ISO split the scheduler and the
    decoder ask for in it: (site, length, tp, chunks)."""
    from repro_torch.models import decoder as dec
    from repro_torch.serving import scheduler
    calls = []

    def recorder(site, fn):
        def split(S, iso_c, cfg, **kw):
            out = fn(S, iso_c, cfg, **kw)
            calls[-1].append((site, S, kw.get("tp"), out))
            return out
        return split

    sched_split, dec_split = scheduler.split_chunks, dec.split_chunks
    scheduler.split_chunks = recorder("scheduler", sched_split)
    dec.split_chunks = recorder("decoder", dec_split)
    serve = []
    try:
        for v in variants:
            calls.append([])
            serve += serve_rank(group, config, [v], params_npz=params_npz)
    finally:
        scheduler.split_chunks, dec.split_chunks = sched_split, dec_split
    return dict(serve=serve, calls=calls)


@pytest.fixture(scope="module")
def mha_tp4(tmp_path_factory):
    """Rank results of the MHA twin at tp=4: the mixed traffic under the
    default (batch-split) schedule with the even split and with the
    ``auto`` split, then two prompts each granted whole at a length that is
    its own bucket (64 and 32 tokens, budget 64) under ``auto``."""
    from repro_torch.layers.heads import head_layout
    layout = head_layout(6, 6, 4)
    assert (layout.hkv_eff, sum(h < 0 for h in layout.kv_map)) == (8, 2)
    ref = r_api.init_params(jax.random.PRNGKey(0), MHA_CFG, tp=4,
                            dtype=jnp.float32)
    path = tmp_path_factory.mktemp("mha_tp4") / "params.npz"
    bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
    name, lengths, seed, new, sv = CASES[0]
    auto = dict(split_policy="auto")
    variants = [dict(prompts=_prompts(lengths, seed), max_new=new,
                     serving=dict(sv)),
                dict(prompts=_prompts(lengths, seed), max_new=new,
                     serving=dict(sv), iso=auto),
                dict(prompts=_prompts((64, 32), 4), max_new=3,
                     serving=dict(sv, prefill_token_budget=64), iso=auto)]
    config = Config(model=MHA_PORT_CFG,
                    parallel=ParallelConfig(data=1, model=4), iso=PORT_ISO,
                    serving=ServingConfig(prefix_sharing=False,
                                          prefill_batching=False))
    return mesh.spawn(_mha_rank_job, 4, args=(str(path), config, variants),
                      device="cpu", timeout_s=300)


def test_mha_tp4_padded_kv_slots_tokens_equal(mha_tp4):
    """6 kv heads over 4 ranks (two zero pad slots): the tp=4 ranks, the
    tp=1 port engine and the JAX engine give the same greedy tokens, under
    the even split and under ``auto`` (ISO invariance)."""
    from repro_torch.serving import PagedEngine, Request
    from repro_torch.serving.requests import SamplingParams
    name, lengths, seed, new, sv = CASES[0]
    prompts = _prompts(lengths, seed)
    ref = r_api.init_params(jax.random.PRNGKey(0), MHA_CFG, tp=1,
                            dtype=jnp.float32)
    r_eng = RPagedEngine(RConfig(model=MHA_CFG,
                                 parallel=RParallel(data=1, model=1),
                                 iso=REF_ISO,
                                 serving=RServing(prefix_sharing=False,
                                                  prefill_batching=False,
                                                  **sv)), ref)
    r_rids = [r_eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    r_out = r_eng.run_until_complete()
    want = [r_out[r] for r in r_rids]
    eng = PagedEngine(Config(model=MHA_PORT_CFG,
                             parallel=ParallelConfig(data=1, model=1),
                             iso=PORT_ISO,
                             serving=ServingConfig(prefix_sharing=False,
                                                   prefill_batching=False,
                                                   **sv)),
                      bridge.from_reference(
                          jax.tree_util.tree_map(np.asarray, ref),
                          device="cpu"), device="cpu")
    rids = [eng.add_request(Request(prompt=p.copy(), sampling=SamplingParams(
        max_new_tokens=new, eos_id=-1))) for p in prompts]
    out = eng.run_until_complete()
    assert [out[r] for r in rids] == want
    for rank in mha_tp4:
        for run in rank["serve"][:2]:
            assert run["tokens"] == want
            assert run["decode_schedule"] == "batch_split"
        assert rank["serve"][2]["tokens"] == mha_tp4[0]["serve"][2]["tokens"]
    even = mha_tp4[0]["serve"][0]["metrics"]
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "prefill_pad_tokens"):
        assert even[k] == r_eng.metrics[k], k


def test_auto_split_plans_at_the_engines_tp(mha_tp4):
    """Under ``auto`` the scheduler's quanta and the decoder's chunks both
    come from the engine's tp (4): a prompt granted whole at a length that
    is its own bucket is cut into the same chunks at both sites, and those
    are ``split_chunks`` at tp=4 (the reference's scheduler splits at its
    default tp=16)."""
    from repro_torch.core.chunking import split_chunks
    iso_auto = ISOConfig(**{**PORT_ISO.__dict__, "split_policy": "auto"})
    for rank in mha_tp4:
        for calls in rank["calls"]:
            assert all(tp == 4 for _, _, tp, _ in calls), calls
        calls = rank["calls"][2]
        plans = {(site, S): chunks for site, S, _, chunks in calls}
        for S in (64, 32):
            want = split_chunks(S, iso_auto, MHA_PORT_CFG, tp=4)
            assert len(want) == 2
            assert plans[("scheduler", S)] == plans[("decoder", S)] == want


# ---------------------------------------------------------------------------
# expert parallelism: MoE twins at tp=2 and tp=4
# ---------------------------------------------------------------------------

# tiny_moe (4 experts: 2 a rank at tp=2, 1 at tp=4; a shared expert split
# as the dense MLP) and a 5-expert twin at capacity 1.25 (padded to 6 at
# tp=2 and to 8 at tp=4, the padding experts masked out of the router)
MOE_TWINS = {
    "moe4": tiny_moe(vocab_size=64),
    "moe5_cf1.25": tiny_moe(vocab_size=64, moe=RMoEConfig(
        num_experts=5, top_k=2, d_ff_expert=64, capacity_factor=1.25)),
}
# (decode schedule, forced split count) of each rank-side run, on CASES[0]'s
# traffic: the default batch-split, and sequential over 4 split-KV spans
MOE_RUNS = (("auto", 0), ("sequential", 4))


def _moe_port_cfg(ref_cfg):
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return ModelConfig(**kw)


def _moe_rank_job(group, jobs):
    """Serve each twin's runs from its params (built at the group's tp)."""
    return [serve_rank(group, config, variants, params_npz=path)
            for path, config, variants in jobs]


@pytest.fixture(scope="module")
def moe_tp_runs(tmp_path_factory):
    """tp -> (per-rank results by twin, the reference tokens by twin): the
    reference ``PagedEngine(mesh=None)`` on the same tp-built params."""
    cache = {}

    def get(tp):
        if tp in cache:
            return cache[tp]
        name, lengths, seed, new, sv = CASES[0]
        prompts = _prompts(lengths, seed)
        jobs, want = [], {}
        for twin, rcfg in MOE_TWINS.items():
            ref = r_api.init_params(jax.random.PRNGKey(0), rcfg, tp=tp,
                                    dtype=jnp.float32)
            assert ref["periods"][0]["moe"]["router"].shape[-1] == \
                rcfg.moe.padded_experts(tp)
            path = tmp_path_factory.mktemp(f"{twin}_tp{tp}") / "p.npz"
            bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
            r_eng = RPagedEngine(RConfig(
                model=rcfg, parallel=RParallel(data=1, model=1), iso=REF_ISO,
                serving=RServing(prefix_sharing=False, prefill_batching=False,
                                 **sv)), ref)
            rids = [r_eng.add_request(RRequest(
                prompt=p.copy(), sampling=RSampling(max_new_tokens=new,
                                                    eos_id=-1)))
                for p in prompts]
            out = r_eng.run_until_complete()
            want[twin] = ([out[r] for r in rids], dict(r_eng.metrics))
            config = Config(model=_moe_port_cfg(rcfg),
                            parallel=ParallelConfig(data=1, model=tp),
                            iso=PORT_ISO,
                            serving=ServingConfig(prefix_sharing=False,
                                                  prefill_batching=False))
            variants = [dict(prompts=prompts, max_new=new,
                             serving=dict(sv, decode_schedule=sched,
                                          decode_kv_splits=splits))
                        for sched, splits in MOE_RUNS]
            jobs.append((str(path), config, variants))
        res = mesh.spawn(_moe_rank_job, tp, args=(jobs,), device="cpu",
                         timeout_s=300)
        cache[tp] = ({twin: [r[i] for r in res]
                      for i, twin in enumerate(MOE_TWINS)}, want)
        return cache[tp]
    return get


@pytest.mark.parametrize("twin", sorted(MOE_TWINS))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_moe_engine_tokens_equal_reference(moe_tp_runs, tp, twin):
    """Each rank serves its experts (``expert_offset``) and its shard of the
    shared expert; the partials ride the MLP's all-reduce.  Greedy tokens
    on every rank, under batch-split and under sequential split-KV decode,
    equal the reference engine's at tp=1 on the same weights, and the
    prefill counters too."""
    ranks, want = moe_tp_runs(tp)
    tokens, ref_m = want[twin]
    for r, runs in enumerate(ranks[twin]):
        assert len(runs) == len(MOE_RUNS)
        for (sched, splits), run in zip(MOE_RUNS, runs):
            assert run["tokens"] == tokens, (r, sched, run["tokens"], tokens)
            assert run["decode_schedule"] == (
                "batch_split" if sched == "auto" else sched)
    m = ranks[twin][0][0]["metrics"]
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "prefill_pad_tokens"):
        assert m[k] == ref_m[k], (k, m[k], ref_m[k])


# ---------------------------------------------------------------------------
# the recurrent families at tp=2
# ---------------------------------------------------------------------------

RECURRENT_TWINS = {
    "hybrid": RModelConfig(name="hybrid", family="hybrid", num_layers=2,
                           d_model=64, num_heads=8, num_kv_heads=2, d_ff=128,
                           vocab_size=64, block_pattern=("hybrid",),
                           ssm=RSSMConfig(state_dim=8), sliding_window=16),
    "xlstm": RModelConfig(name="xlstm", family="ssm", num_layers=4,
                          d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                          vocab_size=64,
                          block_pattern=("mlstm", "mlstm", "mlstm",
                                         "slstm")),
}
# prompts past the window, resumed grants of 16, 2 slots draining to one
RECURRENT_TRAFFIC = (_prompts((41, 23, 9), 3), 5,
                     dict(prefill_token_budget=16, page_size=8, max_len=96,
                          max_batch=2))


def _recurrent_port_cfg(ref_cfg):
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(ref_cfg.ssm))
    return ModelConfig(**kw)


@pytest.fixture(scope="module")
def recurrent_tp2(tmp_path_factory):
    """(per-rank results by twin, the reference tokens by twin): the
    reference ``PagedEngine(mesh=None)`` on the same tp=2-built params
    (head slots and the SSM's inner dim padded for tp=2)."""
    prompts, new, sv = RECURRENT_TRAFFIC
    jobs, want = [], {}
    for twin, rcfg in RECURRENT_TWINS.items():
        # the port's tp=2-built weights from a seed, carried to the
        # reference by the bridge (its own init compiles for seconds)
        host = bridge.to_reference(decoder.init_decoder_params(
            0, _recurrent_port_cfg(rcfg), tp=2, dtype=torch.float32,
            device="cpu"))
        ref = jax.tree_util.tree_map(jnp.asarray, host)
        path = tmp_path_factory.mktemp(f"{twin}_tp2") / "p.npz"
        bridge.save_npz(path, host)
        r_eng = RPagedEngine(RConfig(
            model=rcfg, parallel=RParallel(data=1, model=1), iso=REF_ISO,
            serving=RServing(**sv)), ref)
        rids = [r_eng.add_request(RRequest(prompt=p.copy(), sampling=RSampling(
            max_new_tokens=new, eos_id=-1))) for p in prompts]
        out = r_eng.run_until_complete()
        want[twin] = ([out[r] for r in rids], dict(r_eng.metrics))
        config = Config(model=_recurrent_port_cfg(rcfg),
                        parallel=ParallelConfig(data=1, model=2),
                        iso=PORT_ISO, serving=ServingConfig(**sv))
        variants = [dict(prompts=prompts, max_new=new,
                         serving=dict(decode_schedule=sched))
                    for sched in ("auto", "sequential")]
        jobs.append((str(path), config, variants))
    res = mesh.spawn(_moe_rank_job, 2, args=(jobs,), device="cpu",
                     timeout_s=300)
    return {twin: [r[i] for r in res]
            for i, twin in enumerate(RECURRENT_TWINS)}, want


@pytest.mark.parametrize("twin", sorted(RECURRENT_TWINS))
def test_tp2_recurrent_engine_tokens_equal_reference(recurrent_tp2, twin):
    ranks, want = recurrent_tp2
    tokens, ref_m = want[twin]
    for r, runs in enumerate(ranks[twin]):
        for sched, run in zip(("batch_split", "sequential"), runs):
            assert run["tokens"] == tokens, (r, sched, run["tokens"], tokens)
            assert run["decode_schedule"] == sched
    m = ranks[twin][0][0]["metrics"]
    for k in ("prefill_calls", "prefill_grants", "resumed_grants",
              "decode_calls", "prefill_pad_tokens", "prefix_shared_tokens"):
        assert m[k] == ref_m[k], (k, m[k], ref_m[k])
