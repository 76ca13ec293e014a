"""The afmoe family (Arcee Trinity: ``AFMOE_KINDS`` blocks, the sigmoid
router's dropless MoE, ``kernels/moe_experts.py``) against the plain
reference ``bench/reference_afmoe.py`` (loaded by path: ``bench/tests`` is
not among these tests), on the CPU at a tiny size: 8 layers (2 dense lead
layers, then MoE; full attention at layers 3 and 7, sliding window 16
elsewhere), d 64, GQA 4/2 with hd 16, 8 experts top-2 plus a shared one,
vocab 512 (``bench/tests/data/configs/tiny-afmoe.json``), seeded random
weights in float32.

Tolerances, all float32: the port and the reference compute the same
function in another order (the port's ISO chunks, paged attention merged
over key blocks, experts over every token, the slot-ordered combine; the
reference's whole-sequence softmax and per-expert row gathers), so logits
agree to float32 rounding accumulated over 8 layers, within 1e-4
absolute; one function computed twice on different batches or chunkings
agrees within 1e-5 (row-wise float32 products whose blocking may change
with the batch).

  * full-prompt logits past the window; prefill through the paged cache
    (batch-1, packed and resumed grants) and 8+ decode steps per request,
    the decode logits against the reference's;
  * a router skewed so that every token picks the same two experts (the
    capacity path's C would drop most of them) gives the reference's
    output on the dropless path;
  * the dropless output does not depend on batching: rows alone or in a
    batch, 1, 2 or 4 ISO chunks, a request decoded alone or beside others,
    prefill packs on or off;
  * the expert bias changes which experts are chosen, never their weights;
  * a sliding layer ignores keys older than the window; a full (NoPE)
    layer is invariant to a shift of every position;
  * at tp=2 the ranks' partials (their experts, their shard of the shared
    expert) sum to the tp=1 layer;
  * the grouped kernels equal the plain path on the card (skipped on the
    CPU);
  * no closure body of an afmoe engine reads a tensor back to the host.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.config import Config, ISOConfig, MoEConfig, \
    ParallelConfig, ServingConfig, SigmoidMoEConfig
from repro_torch.core.overlap import AxisCtx
from repro_torch.kernels import moe_experts as mx
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import moe
from repro_torch.models import api, decoder
from repro_torch.serving import PagedEngine, Request
from repro_torch.serving.requests import SamplingParams

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _bench_module(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_{name}", REPO / "bench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference_afmoe = _bench_module("reference_afmoe")
port_afmoe = _bench_module("port_afmoe")

with open(REPO / "bench" / "tests" / "data" / "configs" /
          "tiny-afmoe.json") as f:
    CFG = json.load(f)
MC = port_afmoe.model_config(CFG)
V = CFG["vocab_size"]
ATOL = 1e-4           # port against reference (module doc)
SAME = 1e-5           # one function, two batchings
ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                chunk_align=8)


@pytest.fixture(scope="module")
def params():
    return api.init_params(7, MC, dtype=torch.float32, device="cpu")


def _reference(params):
    return reference_afmoe.Reference(CFG, params)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(2, V, n).astype(np.int32)


def test_config_reads_the_published_keys():
    assert MC.block_pattern == (
        "afmoe_swa_mlp", "afmoe_swa_mlp", "afmoe_swa_moe", "afmoe_full_moe",
        "afmoe_swa_moe", "afmoe_swa_moe", "afmoe_swa_moe", "afmoe_full_moe")
    assert isinstance(MC.moe, SigmoidMoEConfig)
    assert (MC.sliding_window, MC.embed_scale) == (16, 8.0)
    # q, k, v, o, the gate and 4 norms a layer; 2 dense SwiGLUs; 6 MoE
    # layers of 8 experts, the shared one, the router and the bias (the
    # final norm is not counted, as the reference counts none)
    d, attn = 64, 2 * 64 * 64 + 2 * 64 * 32
    layer = attn + 64 * 64 + 4 * d
    want = 2 * 512 * d + 8 * layer + 2 * 3 * d * 96 + \
        6 * (9 * 3 * d * 32 + d * 8 + 8)
    assert MC.param_count() == want


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_prompt_logits_equal_reference(params, chunks):
    toks = _prompt(60, 1)
    iso = ISOConfig(enabled=True, num_chunks=chunks, min_chunk_tokens=8,
                    chunk_align=8)
    out = api.prefill(params, MC, AxisCtx(), iso,
                      {"tokens": torch.as_tensor(toks)[None]},
                      logits_mode="all")
    assert out["num_chunks"] == chunks
    port = out["logits_local"][0, :, :V]
    ref = _reference(params).logits([torch.as_tensor(toks)],
                                    [torch.arange(60)])[0]
    assert torch.allclose(port, ref, atol=ATOL, rtol=0), \
        (port - ref).abs().max()


class _Recorder:
    """Each decode call's logits rows by request, in order (wrapping the
    engine's ``_pick``, which sees every call's gathered logits)."""

    def __init__(self, eng):
        self.rows = {}
        pick = eng._pick

        def wrapped(logits, rows, host_rows):
            if logits.ndim == 3:                      # a decode call
                for slot in rows:
                    rid = eng.slots[slot].request.rid
                    self.rows.setdefault(rid, []).append(
                        logits[slot, 0, :V].clone())
            return pick(logits, rows, host_rows)

        eng._pick = wrapped


def _serve(params, prompts, new=10, **sv):
    sv = dict(dict(page_size=8, max_batch=4, max_len=128,
                   prefill_token_budget=32), **sv)
    eng = PagedEngine(Config(model=MC, parallel=ParallelConfig(data=1,
                                                               model=1),
                             iso=ISO, serving=ServingConfig(**sv)),
                      params, device="cpu")
    rec = _Recorder(eng)
    for rid, p in prompts.items():
        eng.add_request(Request(prompt=p, rid=rid, sampling=SamplingParams(
            max_new_tokens=new, eos_id=-1)))
    return eng, eng.run_until_complete(), rec.rows


PROMPTS = {0: _prompt(45, 2), 1: _prompt(23, 3), 2: _prompt(70, 4),
           3: _prompt(9, 5)}


@pytest.fixture(scope="module")
def served(params):
    return _serve(params, PROMPTS)


def test_paged_prefill_and_decode_equal_reference(params, served):
    """Grants cut at the 32-token budget (resumed), packed, and 10 tokens
    each decoded through the pages, lengths up to 79 past the window: the
    decode logits are the reference's, and every served token is the
    reference's first."""
    eng, out, rows = served
    assert eng.metrics["resumed_grants"] > 0
    ref = _reference(params)
    for rid, p in PROMPTS.items():
        toks = out[rid]
        assert len(toks) == 10 and len(rows[rid]) == 9
        seq = torch.as_tensor(np.concatenate([p, np.asarray(toks[:-1],
                                                            np.int32)]))
        P = len(p)
        lg = ref.logits([seq], [torch.arange(P - 1, P + 9)])[0]
        assert lg.argmax(-1).tolist() == toks
        got = torch.stack(rows[rid])
        assert torch.allclose(got, lg[1:], atol=ATOL, rtol=0), \
            (rid, (got - lg[1:]).abs().max())


def test_decode_does_not_depend_on_the_batch(params, served):
    """A request decoded alone, or beside others with prefill packs off,
    gets the same logits at every step."""
    _, out, rows = served
    for rid in (0, 2):
        _, alone, alone_rows = _serve(params, {rid: PROMPTS[rid]})
        assert alone[rid] == out[rid]
        for a, b in zip(alone_rows[rid], rows[rid]):
            assert torch.allclose(a, b, atol=SAME, rtol=0)
    _, unpacked, unpacked_rows = _serve(params, PROMPTS,
                                        prefill_batching=False)
    assert unpacked == out
    for rid in PROMPTS:
        for a, b in zip(unpacked_rows[rid], rows[rid]):
            assert torch.allclose(a, b, atol=SAME, rtol=0)


def _moe_layer(tp=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return moe.init_moe(gen, 64, MC.moe, tp, MC.num_layers, torch.float32,
                        torch.device("cpu"))


def test_dropless_rows_do_not_depend_on_the_batch():
    p = _moe_layer()
    x = torch.randn((1, 40, 64), generator=torch.Generator().manual_seed(1))
    whole = moe.moe_dropless(p, x, MC.moe, tp=1, expert_offset=0)
    for lo, hi in ((0, 1), (5, 13), (13, 40)):
        part = moe.moe_dropless(p, x[:, lo:hi], MC.moe, tp=1,
                                expert_offset=0)
        assert torch.allclose(part, whole[:, lo:hi], atol=SAME, rtol=0)


def test_skewed_router_equals_reference_where_capacity_drops():
    """The bias sends every token to experts 5 and 6: a capacity buffer of
    C slots an expert (the softmax router's, at this call's size) would
    drop most of them; the dropless layer computes all, as the
    reference."""
    p = _moe_layer(seed=2)
    p["expert_bias"] = torch.zeros(8)
    p["expert_bias"][[5, 6]] = 10.0
    T = 48
    x = torch.randn((1, T, 64), generator=torch.Generator().manual_seed(3))
    _, idx = moe.route_sigmoid(p["router"], p["expert_bias"], x[0], MC.moe,
                               8)
    assert sorted(set(idx.flatten().tolist())) == [5, 6]
    cap = moe.capacity(T, MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
                       8)
    assert T > 2 * cap                      # most assignments over capacity
    got = moe.moe_dropless(p, x, MC.moe, tp=1, expert_offset=0)[0]
    ref = _reference(None)
    want = ref._moe(ref._moe_weights(p), x[0])
    assert torch.allclose(got, want, atol=ATOL, rtol=0), \
        (got - want).abs().max()


def test_expert_bias_chooses_but_weighs_nothing():
    p = _moe_layer(seed=4)
    x = torch.randn((64, 64), generator=torch.Generator().manual_seed(5))
    zero = torch.zeros(8)
    bias = torch.linspace(-0.3, 0.3, 8)
    w0, i0 = moe.route_sigmoid(p["router"], zero, x, MC.moe, 8)
    w1, i1 = moe.route_sigmoid(p["router"], bias, x, MC.moe, 8)
    assert (i0 != i1).any()                 # the bias moved some choices
    s = torch.sigmoid(x @ p["router"])
    want = s.gather(1, i1)
    want = want / (want.sum(-1, keepdim=True) + 1e-20) * MC.moe.route_scale
    assert torch.allclose(w1, want, atol=1e-6, rtol=0)
    assert torch.allclose(w1.sum(-1), torch.full((64,), 2.5), atol=1e-5)


def _attn_params():
    gen = torch.Generator().manual_seed(8)
    layout = decoder.head_layout(4, 2, 1)
    return decoder._init_attention(gen, MC, layout, torch.float32,
                                   torch.device("cpu"), gate=True)


def test_sliding_layer_ignores_keys_older_than_the_window():
    p = _attn_params()
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((1, 40, 64), generator=gen)
    y = x.clone()
    y[:, :24] = torch.randn((1, 24, 64), generator=gen)   # keys 0..23
    kw = dict(start_pos=0, window=16, rope=True)
    a = attn_lib.attn_prefill_partial(p, x, MC, 2, **kw)[0]
    b = attn_lib.attn_prefill_partial(p, y, MC, 2, **kw)[0]
    # query 39 attends keys 24..39 only
    assert torch.allclose(a[:, 39:], b[:, 39:], atol=1e-6, rtol=0)
    assert not torch.allclose(a[:, 30:39], b[:, 30:39], atol=1e-3)


def test_full_layer_is_invariant_to_a_position_shift():
    """NoPE: a shift of every position changes nothing, and neither does
    an order of the earlier keys (the last query's output); with RoPE the
    order matters (a shift alone would not show it: RoPE scores depend on
    relative positions only)."""
    p = _attn_params()
    x = torch.randn((1, 30, 64), generator=torch.Generator().manual_seed(10))
    nope = [attn_lib.attn_prefill_partial(p, x, MC, 2, start_pos=s,
                                          rope=False)[0] for s in (0, 500)]
    assert torch.allclose(nope[0], nope[1], atol=1e-6, rtol=0)
    y = torch.cat([x[:, :29].flip(1), x[:, 29:]], dim=1)
    for rope, same in ((False, True), (True, False)):
        a, b = (attn_lib.attn_prefill_partial(p, z, MC, 2, start_pos=0,
                                              rope=rope)[0][:, 29]
                for z in (x, y))
        assert torch.allclose(a, b, atol=1e-6, rtol=0) == same, rope


def test_reduced_config_keeps_the_shape_and_serves():
    """``reduce_cfg`` cuts the published configuration to 8 layers that keep
    the dense lead and the 3:1 sliding/full cycle, and the cut serves; the
    dense ``Engine``'s ring caches take one window for every layer and
    refuse the family."""
    from repro_torch.launch.serve import reduce_cfg
    with open(REPO / "bench" / "configs" / "trinity-mini.json") as f:
        full = port_afmoe.model_config(json.load(f))
    # embedding and head, q/o/gate 2048 x 4096 and k/v 2048 x 512 with 4
    # norms a layer, 2 dense SwiGLUs of 6,144, 30 MoE layers of 128 + 1
    # experts of 3 x 2048 x 1024, the router and the bias: 26.12 B
    attn = 3 * 2048 * 4096 + 2 * 2048 * 512 + 4 * 2048
    moe_layer = 129 * 3 * 2048 * 1024 + 2048 * 128 + 128
    assert full.param_count() == 2 * 200_192 * 2048 + 32 * attn + \
        2 * 3 * 2048 * 6144 + 30 * moe_layer == 26_123_964_160
    cut = reduce_cfg(full, "tiny")
    assert cut.block_pattern == MC.block_pattern
    assert isinstance(cut.moe, SigmoidMoEConfig) and \
        cut.moe.route_scale == full.moe.route_scale
    assert cut.embed_scale == cut.d_model ** 0.5
    p = api.init_params(0, cut, dtype=torch.float32, device="cpu")
    eng = PagedEngine(Config(model=cut, parallel=ParallelConfig(data=1,
                                                                model=1),
                             iso=ISO, serving=ServingConfig(
                                 page_size=8, max_batch=2, max_len=96)),
                      p, device="cpu")
    eng.add_request(Request(prompt=_prompt(70, 6) % cut.vocab_size, rid=0,
                            sampling=SamplingParams(max_new_tokens=4,
                                                    eos_id=-1)))
    assert len(eng.run_until_complete()[0]) == 4
    with pytest.raises(NotImplementedError):
        api.init_caches(cut, 1, 32, device="cpu")


def test_tp2_partials_sum_to_the_layer():
    """Each rank computes its own experts' part and its shard of the shared
    expert; the router and the bias are replicated."""
    p = _moe_layer(tp=2, seed=11)
    x = torch.randn((2, 12, 64), generator=torch.Generator().manual_seed(12))
    whole = moe.moe_dropless(p, x, MC.moe, tp=1, expert_offset=0)
    parts = [moe.moe_dropless(decoder._shard_tree(p, r, 2, "moe"), x,
                              MC.moe, tp=2, expert_offset=4 * r)
             for r in range(2)]
    assert parts[0].shape == whole.shape
    assert torch.allclose(parts[0] + parts[1], whole, atol=SAME, rtol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the grouped kernels run on the "
                    "card only")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("T,decode", [(24, True), (300, False)])
def test_grouped_kernels_equal_the_plain_path(card, T, decode):
    """At Trinity-Mini's widths, bf16: within 2e-2 of the largest output
    (the kernel keeps x Wg and x Wu in fp32 before the SiLU product, the
    plain path rounds them to bf16)."""
    gen = torch.Generator(device=card).manual_seed(13)
    E, D, Fw, k = 128, 2048, 1024, 8
    ws = [(torch.randn(sh, generator=gen, device=card) * 0.02).bfloat16()
          for sh in ((E, D, Fw), (E, D, Fw), (E, Fw, D))]
    x = torch.randn((T, D), generator=gen, device=card).bfloat16()
    w, idx = torch.topk(torch.rand((T, E), generator=gen, device=card), k)
    y, c = mx.moe_experts(x, idx, w, *ws, decode=decode)
    yp, cp = mx.moe_experts_plain(x, idx, w, *ws)
    assert torch.equal(c, cp)
    assert (y - yp).abs().max() <= 2e-2 * yp.abs().max()


class _NoHostReads(TorchFunctionMode):
    """Raises on every way a tensor's value reaches the host, and on a
    tensor made from host data (as tests/test_torch_moe.py's guard)."""
    BANNED = {"item", "__int__", "__float__", "__bool__", "__index__",
              "cpu", "tolist", "numpy", "tensor", "as_tensor",
              "from_numpy", "nonzero"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.BANNED:
            raise AssertionError(f"host read on the captured path: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", ["fresh", "resumed", "packed", "decode"])
def test_closure_bodies_read_nothing_back(params, which):
    eng = PagedEngine(Config(model=MC, parallel=ParallelConfig(data=1,
                                                               model=1),
                             iso=ISO,
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
        fn = eng._get_decode(1, 1)
        fn.stage(toks=np.ones((3, 1), np.int32),
                 lengths=np.asarray([20, 9, 0], np.int32), bt=rows,
                 mask=np.asarray([True, True, False]))
    with _NoHostReads():
        out = fn()
    assert torch.isfinite(out).all()
    assert int(eng.moe_hits) > 0            # counted on the device
