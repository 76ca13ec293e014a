"""``launch/runner.py`` and the dense ``Engine`` under tensor parallelism,
against the JAX reference, on gloo ranks on the CPU, fp32:

  * one ``mesh.spawn`` at tp=2 runs every rank-side case: the dense
    ``Engine(mesh=TPGroup)`` serving the tiny dense twin (plain, spec_k=2
    and with ``quantized_comm``), whisper, the VLM twin and the no-drop MoE
    twin, each rank on its shard of the reference's tp=2 weights: greedy
    tokens equal the reference ``Engine(mesh=None)``'s on the same whole
    weights, on both ranks; ``runner.make_prefill_fn``'s gathered logits
    equal the reference's tp=1 ``api.prefill``; whisper trained 3 steps at
    tp=2: losses equal tp=1's, gradient norms twice tp=1's (the
    reference's psum transpose);
  * the dense ``Engine`` refuses a rank group with data ranks;
  * whisper's rank shard (``api.init_params(..., rank=)``) equals the shard
    of the whole;
  * the batch-split decode schedule over dense caches equals sequential;
  * ``INPUT_SHAPES``, ``list_archs()`` and ``configs.ASSIGNED`` equal the
    reference's; the launcher takes ``--latency-hiding`` and says it has no
    effect.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import iso_cfg, tiny_dense, tiny_moe, tiny_vlm, \
    tiny_whisper  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import INPUT_SHAPES as R_SHAPES  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import list_archs as r_list_archs  # noqa: E402
from repro.configs import ASSIGNED as R_ASSIGNED  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving.requests import SamplingParams as RSampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import INPUT_SHAPES, Config, ISOConfig, \
    ModelConfig, MoEConfig, ParallelConfig, RuntimeConfig, \
    list_archs  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch import mesh, runner, serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving.requests import SamplingParams  # noqa: E402
from repro_torch.training import trainer  # noqa: E402
from repro_torch.training.data import make_training_batch  # noqa: E402

torch.set_num_threads(1)

RISO = iso_cfg(2, min_chunk_tokens=8, chunk_align=8)
ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                chunk_align=8)
TWINS = {"dense": tiny_dense(vocab_size=64), "whisper": tiny_whisper(),
         "vlm": tiny_vlm(), "moe": tiny_moe()}
# (twin, engine kwargs, iso overrides) of each served variant
SERVED = {"dense": ("dense", {}, {}),
          "dense spec_k=2": ("dense", dict(spec_k=2), {}),
          "dense quantized_comm": ("dense", {}, dict(quantized_comm=True)),
          "whisper": ("whisper", {}, {}),
          "vlm": ("vlm", {}, {}),
          "moe": ("moe", {}, {})}
ENGINE = dict(max_batch=2, max_len=64, bucket=16)
NEW = 5
TRAIN_STEPS = 3


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return ModelConfig(**kw)


def _traffic(cfg, seed: int = 3):
    """Four requests (prompts 5-30 tokens) on two slots; whisper's carry
    frames, the VLM's patches."""
    rng = np.random.default_rng(seed)
    reqs = []
    for n in (30, 5, 17, 11):
        r = dict(prompt=rng.integers(2, cfg.vocab_size, n).astype(np.int32))
        if cfg.family == "audio":
            r["frames"] = (rng.standard_normal(
                (cfg.encoder_frames, cfg.d_model)) * 0.1).astype(np.float32)
        if cfg.family == "vlm":
            r["patches"] = (rng.standard_normal(
                (cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32)
        reqs.append(r)
    return reqs


def _port_config(name: str, tp: int, **iso) -> Config:
    return Config(model=port_cfg(TWINS[name]),
                  parallel=ParallelConfig(data=1, model=tp),
                  iso=dataclasses.replace(ISO, **iso),
                  runtime=RuntimeConfig(mode="train", max_steps=20,
                                        warmup_steps=1))


def _train(config, params, group=None):
    """(loss, gnorm) of TRAIN_STEPS steps on the synthetic batches."""
    step = trainer.make_train_step(config, group)
    _, opt = trainer.init_train_state(config, group=group, params=params)
    out = []
    for s in range(TRAIN_STEPS):
        loss, gn = step(params, opt, make_training_batch(
            config.model, 32, 4, s), s)
        out.append((float(loss), float(gn)))
    return out


def _prefill_tokens():
    return np.random.default_rng(4).integers(2, 64, (2, 40)).astype(np.int32)


def _rank_job(group, npz):
    """Every rank-side case on this rank: each served variant's tokens, the
    gathered prefill logits and whisper's training trajectory."""
    local = {k: bridge.shard_params(bridge.load_npz(p), group.rank, group.tp)
             for k, p in npz.items()}
    out = {"served": {}}
    for label, (name, eng_kw, iso) in SERVED.items():
        eng = Engine(_port_config(name, group.tp, **iso), local[name],
                     mesh=group, **ENGINE, **eng_kw)
        rids = [eng.add_request(Request(sampling=SamplingParams(
            max_new_tokens=NEW, eos_id=-1), **r))
            for r in _traffic(eng.cfg)]
        done = eng.run_until_complete()
        out["served"][label] = dict(tokens=[done[r] for r in rids],
                                    spec_calls=eng.metrics["spec_calls"])
    fn = runner.make_prefill_fn(_port_config("dense", group.tp), group,
                                logits_mode="all", global_batch=2)
    res = fn(local["dense"], {"tokens": torch.from_numpy(_prefill_tokens())})
    out["logits"] = runner.gather_logits(res["logits_local"], fn.ctx).numpy()
    out["train"] = _train(_port_config("whisper", group.tp), local["whisper"],
                          group)
    return out


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """(per-rank results, the reference's whole tp=2-built params by twin,
    their npz paths)."""
    ref, npz = {}, {}
    for name, cfg in TWINS.items():
        ref[name] = r_api.init_params(jax.random.PRNGKey(0), cfg, tp=2,
                                      dtype=jnp.float32)
        npz[name] = str(tmp_path_factory.mktemp(name) / "params.npz")
        bridge.save_npz(npz[name], jax.tree_util.tree_map(np.asarray,
                                                          ref[name]))
    ranks = mesh.spawn(_rank_job, 2, args=(npz,), device="cpu",
                       timeout_s=300)
    return ranks, ref, npz


def _reference_tokens(name, params, spec_k=0):
    cfg = TWINS[name]
    eng = REngine(RConfig(model=cfg, parallel=RParallel(data=1, model=1),
                          iso=RISO), params, mesh=None, spec_k=spec_k,
                  **ENGINE)
    rids = [eng.add_request(RRequest(sampling=RSampling(
        max_new_tokens=NEW, eos_id=-1), **r)) for r in _traffic(cfg)]
    done = eng.run_until_complete()
    return [done[r] for r in rids]


@pytest.mark.parametrize("label", list(SERVED))
def test_dense_engine_tp2_equals_reference(tp2, label):
    ranks, ref, _ = tp2
    name, eng_kw, _ = SERVED[label]
    want = _reference_tokens(name, ref[name], **eng_kw)
    for r, rank in enumerate(ranks):
        got = rank["served"][label]
        assert got["tokens"] == want, (label, r)
        assert all(len(t) == NEW for t in got["tokens"])
    if eng_kw.get("spec_k"):
        assert ranks[0]["served"][label]["spec_calls"] > 0


def test_prefill_fn_gathered_logits_equal_reference(tp2):
    ranks, ref, _ = tp2
    want = r_api.prefill(ref["dense"], TWINS["dense"], RAxisCtx(), RISO,
                         {"tokens": jnp.asarray(_prefill_tokens())},
                         logits_mode="all")["logits_local"]
    for rank in ranks:
        np.testing.assert_allclose(rank["logits"], np.asarray(want),
                                   atol=1e-5, rtol=1e-4)


def test_whisper_trains_at_tp2(tp2):
    ranks, _, npz = tp2
    config = _port_config("whisper", 1)
    want = np.array(_train(config, bridge.from_reference(
        bridge.load_npz(npz["whisper"]))))
    for rank in ranks:
        got = np.array(rank["train"])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
        np.testing.assert_allclose(got[:, 1], 2 * want[:, 1], rtol=1e-5)
    assert want[-1, 0] < want[0, 0]


def test_dense_engine_refuses_a_data_parallel_group():
    # the ring caches and slots hold all max_batch rows, while a data rank
    # would decode only its share of them
    config = dataclasses.replace(_port_config("dense", 1),
                                 parallel=ParallelConfig(data=2, model=1))
    params = api.init_params(0, config.model, dtype=torch.float32,
                             device="cpu")
    group = mesh.TPGroup(rank=0, tp=1, device=torch.device("cpu"),
                         backend="gloo", dp=2)
    with pytest.raises(ValueError, match="tensor parallelism only"):
        Engine(config, params, mesh=group, **ENGINE)


def test_whisper_rank_shard_equals_shard_of_whole():
    cfg = port_cfg(TWINS["whisper"])
    whole = api.init_params(5, cfg, tp=2, dtype=torch.float32, device="cpu")
    for rank in range(2):
        want = jax.tree_util.tree_leaves(bridge.to_reference(
            bridge.shard_params(whole, rank, 2)))
        got = jax.tree_util.tree_leaves(bridge.to_reference(
            api.init_params(5, cfg, tp=2, dtype=torch.float32, device="cpu",
                            rank=rank)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_batch_split_decode_over_dense_caches_equals_sequential():
    cfg = port_cfg(TWINS["dense"])
    params = api.init_params(0, cfg, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_prefill_tokens()[:, :24].repeat(2, 0))
    out = api.prefill(params, cfg, AxisCtx(), ISO, {"tokens": toks},
                      logits_mode="none", return_cache=True, cache_len=32)
    caches = {s: tuple({k: v.clone() for k, v in c.items()}
                       for c in out["caches"])
              for s in ("sequential", "batch_split")}
    logits = {s: [] for s in caches}
    lens = torch.full((4,), 24, dtype=torch.int32)
    for step in range(3):
        t = torch.full((4, 1), 7 + step, dtype=torch.int32)
        for s in caches:
            lg, _ = api.decode_step(params, cfg, AxisCtx(), t, caches[s],
                                    lens + step, schedule=s)
            logits[s].append(lg)
    for a, b in zip(logits["sequential"], logits["batch_split"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    for ca, cb in zip(caches["sequential"], caches["batch_split"]):
        for k in ca:
            torch.testing.assert_close(ca[k], cb[k], atol=1e-6, rtol=1e-6)


def test_input_shapes_archs_and_assigned_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in R_SHAPES.items()}
    assert list_archs() == r_list_archs()
    assert ASSIGNED == list(R_ASSIGNED)


def test_latency_hiding_flag_accepted(monkeypatch, capsys):
    seen = {}

    def fake_dense(args, config, *a, **kw):
        seen["config"] = config
        return 0

    monkeypatch.setattr(serve, "_serve_dense", fake_dense)
    assert serve.main(["--arch", "qwen3-8b", "--device", "cpu",
                       "--latency-hiding"]) == 0
    assert seen["config"].serving.latency_hiding is True
    out = capsys.readouterr().out
    assert out.count("[latency-hiding] no effect in the port") == 1
