"""The decode overlap probe in the port (``obs/overlap_probe.py``,
``PagedEngine.measure_overlap_efficiency``) against the reference's, fp32 on
the CPU on bridged weights, after the probe cases of tests/test_obs.py:

  * its dict has the reference's keys and schedules (sequential,
    batch_split, ladder, cross_block on a standard engine; sequential and
    ladder on a ladder-wired one; no batch_split at B = 1), every number in
    it finite, its derived figures consistent with its times;
  * its closures are cached apart, keyed (schedule, comm) as the
    reference's, and the serving closures' keys, the graph count, the pools
    (bit for bit, also with requests resident mid-run) and the next tokens
    are unchanged by a probe;
  * at tp=2 over gloo ranks the probe runs inside ``serve_rank``, which
    serves the same requests again after it and requires the same tokens.

On the CPU (and at tp=1 anywhere) there is no collective to hide, so the
efficiencies are noise about 0: the probe measures nothing here, and on one
card over gloo it times the host's collectives (module doc)."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import ServingConfig as RServing  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import PagedEngine as RPagedEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig, ladder_variant  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import serve_rank  # noqa: E402
from repro_torch.serving import PagedEngine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402

torch.set_num_threads(1)

REF_CFG = tiny_dense(vocab_size=64)
PORT_CFG = ModelConfig(**{f: getattr(REF_CFG, f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
PORT_ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8)
SV = dict(page_size=8, max_batch=2, max_len=96, prefill_token_budget=48)


@pytest.fixture(scope="module")
def weights():
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                      device="cpu")


def _engine(params, cfg=PORT_CFG, **sv):
    return PagedEngine(Config(model=cfg,
                              parallel=ParallelConfig(data=1, model=1),
                              iso=PORT_ISO,
                              serving=ServingConfig(**dict(SV, **sv))),
                       params, device="cpu")


def _ref_probe(ref_params, **sv):
    eng = RPagedEngine(RConfig(model=REF_CFG,
                               parallel=RParallel(data=1, model=1),
                               iso=iso_cfg(2, min_chunk_tokens=8,
                                           chunk_align=8),
                               serving=RServing(**dict(SV, **sv))),
                       ref_params)
    return eng.measure_overlap_efficiency(iters=1, warmup=1), eng


def _submit(eng, seed, lengths, new=4):
    rng = np.random.default_rng(seed)
    return [eng.add_request(Request(
        prompt=rng.integers(2, 64, n).astype(np.int32),
        sampling=SamplingParams(max_new_tokens=new, eos_id=-1)))
        for n in lengths]


def _finite(res):
    for k, v in res.items():
        if k == "schedules":
            assert all(math.isfinite(t) and t > 0 for t in v.values())
        elif v is not None and not isinstance(v, bool):
            assert math.isfinite(v), (k, v)


@pytest.mark.parametrize("max_batch", [2, 1])
def test_probe_keys_equal_reference(weights, max_batch):
    res = _engine(weights[1], max_batch=max_batch) \
        .measure_overlap_efficiency(iters=2, warmup=1)
    want, _ = _ref_probe(weights[0], max_batch=max_batch)
    assert set(res) == set(want)
    assert set(res["schedules"]) == set(want["schedules"])
    assert (res["batch"], res["tp"], res["tokens_resident"],
            res["ladder_proxy"]) == (want["batch"], want["tp"],
                                     want["tokens_resident"],
                                     want["ladder_proxy"])
    _finite(res)
    assert res["t_ladder_s"] == res["schedules"]["ladder"]
    assert res["t_cross_block_s"] == res["schedules"]["cross_block"]
    assert abs(res["overlap_efficiency_ladder"]
               - (1 - res["t_ladder_s"] / res["t_sequential_s"])) < 1e-12
    assert res["comm_total_s"] == max(0.0, res["t_sequential_s"]
                                      - res["t_compute_s"])
    if max_batch < 2:
        assert "batch_split" not in res["schedules"]
        assert res["overlap_efficiency"] == 0.0
        assert res["exposed_comm_s"] is None


def test_probe_leaves_engine_as_it_found_it(weights):
    """A probe run mid-traffic (requests resident, pages live) and again
    after changes no pool byte, no serving closure key, no graph count and
    no token: the engine serves what an unprobed engine serves."""
    params = weights[1]
    eng, plain = _engine(params), _engine(params)
    rids = _submit(eng, 3, (18, 9, 30))
    prids = _submit(plain, 3, (18, 9, 30))
    eng.step()
    plain.step()
    assert eng.alloc.used_pages > 0
    pools = [t.clone() for t in eng.kv.k + eng.kv.v]
    keys, graphs = set(eng._decode_fns), eng.graphs
    res = eng.measure_overlap_efficiency(iters=1, warmup=1)
    _finite(res)
    assert all(torch.equal(a, b) for a, b in zip(pools, eng.kv.k + eng.kv.v))
    assert set(eng._decode_fns) == keys and eng.graphs == graphs
    assert set(eng._probe_decode_fns) == {
        ("sequential", True), ("batch_split", True), ("ladder", True),
        ("cross_block", True), ("sequential", False)}
    outs, pouts = eng.run_until_complete(), plain.run_until_complete()
    assert [outs[r] for r in rids] == [pouts[r] for r in prids]
    eng.measure_overlap_efficiency(iters=1, warmup=0)
    again = _submit(eng, 3, (18, 9, 30))
    outs = eng.run_until_complete()
    assert [outs[r] for r in again] == [pouts[r] for r in prids]
    assert eng.alloc.used_pages == 0


def test_probe_under_split_kv_engine(weights):
    """An engine serving at decode_kv_splits > 1 keeps its probe closures
    at S = 1, keyed (schedule, comm), apart from its (K, S) keys."""
    eng = _engine(weights[1], decode_kv_splits=2)
    _submit(eng, 17, (30, 12))
    eng.run_until_complete()
    keys = set(eng._decode_fns)
    assert any(k[1] > 1 for k in keys)
    eng.measure_overlap_efficiency(iters=1, warmup=1)
    assert set(eng._decode_fns) == keys
    assert all(isinstance(k[0], str) and isinstance(k[1], bool)
               for k in eng._probe_decode_fns)


def test_probe_on_ladder_engine(weights):
    """On a ladder-wired engine the probe times the real twins (no
    batch_split or cross_block: the ladder decode stack owns the overlap)."""
    cfg = ladder_variant(PORT_CFG)
    eng = _engine(weights[1], cfg=cfg)
    assert eng._decode_schedule == "ladder"
    res = eng.measure_overlap_efficiency(iters=2, warmup=1)
    assert set(res["schedules"]) == {"sequential", "ladder"}
    assert res["ladder_proxy"] is False and res["ladder_speedup"] > 0
    _finite(res)
    assert eng._decode_fns == {}
    assert set(eng._probe_decode_fns) == {
        ("sequential", True), ("ladder", True), ("sequential", False)}


def test_probe_at_tp2_over_gloo(tmp_path):
    """tp=2 ranks on the host: the probe's dict on every rank, with the
    schedules of a batch-split engine; ``serve_rank`` serves the requests
    again after it and requires the same tokens."""
    ref = r_api.init_params(jax.random.PRNGKey(0), REF_CFG, tp=2,
                            dtype=jnp.float32)
    path = tmp_path / "params.npz"
    bridge.save_npz(path, jax.tree_util.tree_map(np.asarray, ref))
    config = Config(model=PORT_CFG, parallel=ParallelConfig(data=1, model=2),
                    iso=PORT_ISO, serving=ServingConfig(**SV))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 64, n).astype(np.int32) for n in (20, 11)]
    ranks = mesh.spawn(serve_rank, 2, args=(
        config, [dict(prompts=prompts, max_new=3,
                      probe=dict(iters=2, warmup=1))], str(path)),
        device="cpu", timeout_s=300)
    for (run,) in ranks:
        res = run["probe"]
        assert res["tp"] == 2 and set(res["schedules"]) == {
            "sequential", "batch_split", "ladder", "cross_block"}
        _finite(res)
    assert ranks[0][0]["tokens"] == ranks[1][0]["tokens"]
