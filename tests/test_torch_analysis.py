"""The port's dry run and trace analysis against the JAX package, on the CPU
with no devices (``core/analysis.py``, ``launch/dryrun.py``,
``perf/roofline.py``), and ``attn_impl="blockwise"``:

  * wire bytes of one traced collective of each kind over 2, 4 and 16 ranks
    of PyTorch's ``"fake"`` process-group backend equal the reference's
    ``parse_collectives`` on a one-line HLO of the same shape;
  * the reference's synthetic two-chunk program (tests/test_analysis.py),
    written in torch and traced: 2 collectives against 3, and
    ``avg_hideable_dots`` equal to the reference's on its HLO;
  * ``model_flops`` and ``roofline_terms`` equal to the reference's for
    every assigned arch x input shape (the ``a800`` profile both have);
    ``variant_for_shape`` equal to the reference's;
  * ``lower_shape`` on the tiny dense twin for prefill, decode and train at
    a (data 2, model 4) fake mesh: the traced all-reduces are every
    all-reduce the program issued (and, serving, every ``psum_start``),
    the reference's report keys; prefill's ISO ``hideable_fraction`` above
    iso-off's, and decode and train the same program with ISO on and off
    (equal collectives, wire bytes and ``hideable_fraction``: the
    reference applies ISO to prefill only); one production cell (qwen3-8b
    x decode_32k, 16 x 16, the sequential decode); the quantized train_4k
    cell listed as a failure, not a crash;
  * ``sdpa_blockwise`` against the reference's past one key block (window,
    ``k_valid``, group 4), and a tiny dense prefill with
    ``attn_impl="blockwise"`` against the reference's (fp32, atol 1e-5).
"""
import dataclasses
import importlib
import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import INPUT_SHAPES as R_SHAPES  # noqa: E402
from repro.config import get_model_config as r_get  # noqa: E402
from repro.configs import ASSIGNED as R_ASSIGNED  # noqa: E402
from repro.core.analysis import overlap_metric as r_overlap  # noqa: E402
from repro.core.analysis import parse_collectives as r_parse  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.layers import attention as r_attn  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.perf import roofline as r_roofline  # noqa: E402
from test_analysis import _synthetic_hlo  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import INPUT_SHAPES, ISOConfig, ModelConfig, \
    ParallelConfig, get_model_config  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.core import analysis, iso, overlap  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.core.quantized_collectives import \
    _all_gather_into  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.layers import attention  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense()
PORT_CFG = ModelConfig(**{f.name: getattr(REF_CFG, f.name)
                          for f in dataclasses.fields(ModelConfig)})
SMALL_MESH = ParallelConfig(data=2, model=4)
# reduce-scatter into one tensor, under its newer name where torch has it
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.fixture(scope="module")
def r_dryrun():
    """The reference's dryrun module, imported with ``XLA_FLAGS`` put back
    after its import-time write (512 host devices), so no later JAX
    backend in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ---------------------------------------------------------------------------
# collectives and the overlap metric
# ---------------------------------------------------------------------------

def _one_collective(kind: str, group, n: int):
    """One ``kind`` collective over ``group`` (``n`` ranks) whose result
    buffer is f32 (128, 256), on meta tensors."""
    meta = dict(dtype=torch.float32, device="meta")
    if kind == "all-reduce":
        dist.all_reduce(torch.empty(128, 256, **meta), group=group)
    elif kind == "all-gather":
        _all_gather_into(torch.empty(128, 256, **meta),
                         torch.empty(128 // n, 256, **meta), group=group)
    elif kind == "reduce-scatter":
        _reduce_scatter_into(torch.empty(128, 256, **meta),
                             torch.empty(128 * n, 256, **meta),
                             group=group)
    elif kind == "all-to-all":
        dist.all_to_all_single(torch.empty(128, 256, **meta),
                               torch.empty(128, 256, **meta), group=group)
    else:
        dist.send(torch.empty(128, 256, **meta), dst=1, group=group)


def _hlo_line(kind: str, n: int) -> str:
    groups = "{{" + ",".join(map(str, range(n))) + "}}"
    attrs = (f"source_target_pairs={{{{0,1}},{{1,0}}}}"
             if kind == "collective-permute" else f"replica_groups={groups}")
    return f"  %c = f32[128,256] {kind}(%a), {attrs}\n"


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_reference(kind, n):
    with dryrun.fake_world(ParallelConfig(data=1, model=16)):
        group = dist.new_group(list(range(n)))
        _, tr = analysis.trace_program(_one_collective, kind, group, n)
    st = analysis.parse_collectives(tr)
    want = r_parse(_hlo_line(kind, n))
    assert dict(st.counts) == dict(want.counts) == {kind: 1}
    assert dict(st.buffer_bytes) == dict(want.buffer_bytes)
    assert st.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)


def _synthetic(iso_on: bool, group):
    """The reference's synthetic two-chunk TP layer (tests/test_analysis.py
    ``_synthetic_hlo``) in torch: baseline, every dot depends on the
    previous all-reduce; ISO, chunk 1's dot is independent of AR(c0)."""
    x0, x1 = (torch.empty(8, 32, device="meta") for _ in range(2))
    w1, w2 = (torch.empty(32, 32, device="meta") for _ in range(2))

    def ar(t):
        dist.all_reduce(t, group=group)
        return t

    if iso_on:
        a0, a1 = x0 @ w1, x1 @ w1
        r0 = ar(a0)
        s0 = x0 + r0
        r1 = ar(a1)
        b0 = s0 @ w2
        s1 = x1 + r1
        b1 = s1 @ w2
        return b0 + b1
    a0 = x0 @ w1
    r0 = ar(a0)
    s0 = x0 + r0
    b0 = s0 @ w2
    rb0 = ar(b0)
    a1 = rb0 @ w1
    r1 = ar(a1)
    b1 = r1 @ w2
    return b1 + b1


def test_overlap_metric_equals_reference_on_synthetic_program():
    got = {}
    with dryrun.fake_world(ParallelConfig(data=1, model=2)) as g:
        for iso_on in (True, False):
            got[iso_on] = analysis.overlap_metric(analysis.trace_program(
                _synthetic, iso_on, g.group)[1])
    for iso_on in (True, False):
        want = r_overlap(_synthetic_hlo(iso=iso_on))
        for key in ("collectives", "avg_hideable_dots", "hideable_fraction",
                    "total_dots"):
            assert got[iso_on][key] == want[key], (iso_on, key)
        assert set(got[iso_on]) == set(want)
    assert got[True]["collectives"] == 2 and got[False]["collectives"] == 3
    assert got[True]["avg_hideable_dots"] >= 1.5
    assert got[False]["avg_hideable_dots"] == 0.0


# ---------------------------------------------------------------------------
# roofline and the shape variants
# ---------------------------------------------------------------------------

def test_roofline_and_variants_equal_reference(r_dryrun):
    assert ASSIGNED == list(R_ASSIGNED)
    report = {"flops_per_device": 3.7e14, "bytes_per_device": 2.9e11,
              "collective_wire_bytes_per_device": 4.1e9, "devices": 256}
    for arch in ASSIGNED:
        cfg, rcfg = get_model_config(arch), r_get(arch)
        for name in INPUT_SHAPES:
            shape, rshape = INPUT_SHAPES[name], R_SHAPES[name]
            assert roofline.model_flops(cfg, shape) == \
                r_roofline.model_flops(rcfg, rshape)
            assert roofline.roofline_terms(report, cfg, shape, "a800") == \
                r_roofline.roofline_terms(report, rcfg, rshape, "a800")
            got = dryrun.variant_for_shape(cfg, name)
            want = r_dryrun.variant_for_shape(rcfg, name)
            assert (got is None) == (want is None), (arch, name)
            if got is not None:
                assert got.sliding_window == want.sliding_window
    assert (dryrun.LONG_SKIP, dryrun.LONG_WINDOW) == \
        (r_dryrun.LONG_SKIP, r_dryrun.LONG_WINDOW)


# ---------------------------------------------------------------------------
# lower_shape
# ---------------------------------------------------------------------------

# the reference's report: lower_shape's keys (src/repro/launch/dryrun.py)
REPORT_KEYS = {"arch", "shape", "mesh", "devices", "iso", "num_chunks",
               "compile_s", "flops_per_device", "bytes_per_device",
               "collective_counts", "collective_wire_bytes_per_device",
               "memory", "roofline"}
MEMORY_KEYS = {"args_bytes", "out_bytes", "temp_bytes", "code_bytes"}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_lower_shape_tiny_counts_and_overlap(shape, monkeypatch):
    calls = {"psum_start": 0, "all_reduce": 0}
    real_start, real_ar = overlap.psum_start, dist.all_reduce

    def counting_start(*a, **kw):
        calls["psum_start"] += 1
        return real_start(*a, **kw)

    def counting_ar(*a, **kw):
        calls["all_reduce"] += 1
        return real_ar(*a, **kw)

    monkeypatch.setattr(overlap, "psum_start", counting_start)
    monkeypatch.setattr(iso, "psum_start", counting_start)
    monkeypatch.setattr(dist, "all_reduce", counting_ar)
    frac, reports = {}, {}
    for iso_on in (True, False):
        calls.update(psum_start=0, all_reduce=0)
        report, tr = dryrun.trace_shape("t-dense", shape, cfg=PORT_CFG,
                                        parallel=SMALL_MESH, iso_on=iso_on,
                                        verbose=False)
        reports[iso_on] = report
        n_ar = report["collective_counts"]["all-reduce"]
        assert n_ar == calls["all_reduce"] > 0
        if shape != "train_4k":
            assert n_ar == calls["psum_start"]
        frac[iso_on] = analysis.overlap_metric(tr)["hideable_fraction"]
        assert set(report) == REPORT_KEYS
        assert set(report["memory"]) == MEMORY_KEYS
        r = report["roofline"]
        assert r["compute_s"] > 0 and r["memory_s"] > 0 and \
            r["collective_s"] > 0
        assert report["devices"] == 8 and report["mesh"] == "2x4"
        assert report["memory"]["temp_bytes"] > 0
    if shape == "prefill_32k":
        assert frac[True] > frac[False]
    else:
        # the reference's dry run: ISO on prefill only, so a decode or
        # train cell is the same program with and without it
        for key in ("collective_counts", "collective_wire_bytes_per_device"):
            assert reports[True][key] == reports[False][key], key
        assert frac[True] == frac[False]


def test_production_pair_and_quantized_refusal(tmp_path, capsys):
    t0 = time.perf_counter()
    report = dryrun.lower_shape("qwen3-8b", "decode_32k")
    assert time.perf_counter() - t0 < 60
    assert report["devices"] == 256 and report["mesh"] == "16x16"
    # the sequential decode: an all-reduce per stage, and the embedding's
    assert report["collective_counts"] == {"all-reduce": 2 * 36 + 1}
    assert report["collective_wire_bytes_per_device"] > 0
    assert report["roofline"]["bottleneck"] == "memory"
    assert "hideable_fraction" in capsys.readouterr().out
    out = tmp_path / "q.json"
    rc = dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k",
                      "--quantized", "--out", str(out)])
    data = json.loads(out.read_text())
    assert rc == 1 and not data["reports"]
    (arch, shape, mp, msg), = data["failures"]
    assert (arch, shape, mp) == ("qwen3-8b", "train_4k", False)
    assert "int8 TP reduces under autograd" in msg
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# attn_impl="blockwise"
# ---------------------------------------------------------------------------

def test_sdpa_blockwise_equals_reference():
    rng = np.random.default_rng(0)
    B, Sq, Sk, hkv, g, hd = 2, 40, 300, 2, 4, 16
    q = rng.standard_normal((B, Sq, hkv * g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, hkv, hd)).astype(np.float32)
            for _ in range(2))
    k_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    q_pos = (Sk - Sq + np.arange(Sq, dtype=np.int32))[None].repeat(B, 0)
    k_valid = rng.random((B, Sk)) < 0.9
    for causal, window, kv in ((True, 0, None), (True, 70, k_valid),
                               (False, 0, k_valid)):
        kw = dict(causal=causal, window=window, group_eff=g, block_k=64)
        want = r_attn.sdpa_blockwise(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
            k_valid=None if kv is None else jnp.asarray(kv), **kw)
        got = attention.sdpa_blockwise(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
            k_valid=None if kv is None else torch.from_numpy(kv), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        dense = attention.sdpa(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
            k_valid=None if kv is None else torch.from_numpy(kv),
            causal=causal, window=window, group_eff=g)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_blockwise_prefill_equals_reference():
    rcfg = dataclasses.replace(REF_CFG, attn_impl="blockwise",
                               attn_block_k=16)
    cfg = dataclasses.replace(PORT_CFG, attn_impl="blockwise",
                              attn_block_k=16)
    ref = r_api.init_params(jax.random.PRNGKey(0), rcfg, tp=1,
                            dtype=jnp.float32)
    params = bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref))
    toks = np.random.default_rng(1).integers(2, 128, (2, 56)).astype(
        np.int32)
    from conftest import iso_cfg
    want = r_api.prefill(ref, rcfg, RAxisCtx(), iso_cfg(2), {
        "tokens": jnp.asarray(toks)}, logits_mode="all")["logits_local"]
    got = api.prefill(params, cfg, AxisCtx(), ISOConfig(
        enabled=True, num_chunks=2, min_chunk_tokens=2, chunk_align=4),
        {"tokens": torch.from_numpy(toks)}, logits_mode="all")
    np.testing.assert_allclose(got["logits_local"].numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
