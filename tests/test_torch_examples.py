"""The five ``examples/*_torch.py`` scripts on the CPU, against the
reference's examples on the same weights (made by the reference's
``api.init_params`` and carried across by ``bridge.from_reference``) and
the same numpy inputs:

  * quickstart: the ISO chunk count and lengths equal to the reference's,
    baseline and ISO logits equal to the reference's ``api.prefill`` within
    fp32 atol 1e-5, the ``4090`` and ``a800`` speedup rows exactly equal to
    the reference's ``speedup_table``;
  * iso_prefill_demo: all nine policy x chunk-count splits equal to the
    reference's ``split_chunks``, the three policies' logits at two chunks
    equal to the reference's within atol 1e-5, and the paper-70b
    ``prefill_time`` rows on ``4090`` and ``a800`` exactly equal;
  * speculative_demo: tokens, ``decode_calls`` and ``spec_accepted`` at
    spec_k 0 and 3 equal to the reference's dense ``Engine``'s;
  * serve_batch: the launcher's dense and paged runs return 0;
  * train_small: 4 steps with finite losses and a checkpoint that loads
    back into the model's leaves.

Each script is loaded by path and driven in this process."""
import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    """The module of ``examples/<name>_torch.py``."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_twin(cfg):
    """The reference's ModelConfig with the port's config's fields."""
    from repro.config import ModelConfig as RModelConfig
    return RModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(RModelConfig)})


def reference_iso(iso):
    from repro.config import ISOConfig as RISOConfig
    return RISOConfig(**dataclasses.asdict(iso))


def bridged_weights(rcfg):
    """(reference params, the port's params): the reference's fp32 model
    from PRNGKey(0), bridged to the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import api as r_api
    ref = r_api.init_params(jax.random.PRNGKey(0), rcfg, tp=1,
                            dtype=jnp.float32)
    return ref, bridge.from_reference(
        jax.tree_util.tree_map(np.asarray, ref), device="cpu")


def test_quickstart_equals_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.overlap import AxisCtx as RAxisCtx
    from repro.models import api as r_api
    from repro.perf.model import speedup_table as r_speedup_table
    qs = load("quickstart")
    rcfg = reference_twin(qs.CFG)
    ref_params, params = bridged_weights(rcfg)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (qs.BATCH, qs.SEQ_LEN)).astype(np.int32)
    out = qs.run(params=params, device="cpu", tokens=tokens)

    batch = {"tokens": jnp.asarray(tokens)}
    want_base = r_api.prefill(ref_params, rcfg, RAxisCtx(),
                              reference_iso(dataclasses.replace(
                                  qs.ISO, enabled=False)), batch)
    want = r_api.prefill(ref_params, rcfg, RAxisCtx(), reference_iso(qs.ISO),
                         batch)
    assert out["baseline_chunks"] == want_base["num_chunks"] == 1
    assert out["num_chunks"] == want["num_chunks"] == 2
    assert out["chunk_lengths"] == tuple(want["chunk_lengths"])
    for got, ref in ((out["baseline_logits"], want_base),
                     (out["logits"], want)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref["logits_local"]),
                                   atol=1e-5, rtol=0)
    for hw, tp, int8 in qs.TABLE:
        if hw in qs.MODELLED:
            continue                  # the reference has no h100 profile
        assert out["table"][(hw, tp)] == r_speedup_table(
            rcfg, hw, tp, list(qs.PROMPT_LENGTHS), int8_comm=int8)


def test_iso_prefill_demo_equals_reference():
    jnp = pytest.importorskip("jax.numpy")
    from repro.config import ISOConfig as RISOConfig
    from repro.config import get_model_config as r_get_model_config
    from repro.core.chunking import split_chunks as r_split_chunks
    from repro.core.overlap import AxisCtx as RAxisCtx
    from repro.models import api as r_api
    from repro.perf.model import prefill_time as r_prefill_time
    demo = load("iso_prefill_demo")
    rcfg = reference_twin(demo.CFG)
    ref_params, params = bridged_weights(rcfg)
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (1, demo.SEQ_LEN)).astype(np.int32)
    out = demo.run(params=params, device="cpu", tokens=tokens)

    assert len(out["chunks"]) == 9
    for (policy, n), lengths in out["chunks"].items():
        riso = reference_iso(demo.iso_config(policy, n))
        assert lengths == tuple(r_split_chunks(demo.SEQ_LEN, riso, rcfg)), \
            (policy, n)
    # one JAX compile a chunking: the three policies at two chunks
    batch = {"tokens": jnp.asarray(tokens)}
    for policy in demo.POLICIES:
        want = r_api.prefill(ref_params, rcfg, RAxisCtx(),
                             reference_iso(demo.iso_config(policy, 2)),
                             batch)
        assert out["chunks"][(policy, 2)] == tuple(want["chunk_lengths"])
        np.testing.assert_allclose(out["logits"][(policy, 2)].numpy(),
                                   np.asarray(want["logits_local"]),
                                   atol=1e-5, rtol=0)

    p70 = r_get_model_config("paper-70b")
    for hw, tp in demo.HW_ROWS:
        if hw in demo.MODELLED:
            continue                  # the reference has no h100 profile
        row = out["rows"][(hw, tp)]
        assert row["base_s"] == r_prefill_time(p70, demo.LONG_PROMPT, hw, tp,
                                               iso=False)
        for n in demo.CHUNKS:
            lengths = r_split_chunks(demo.LONG_PROMPT,
                                     RISOConfig(enabled=True, num_chunks=n),
                                     p70, tp=tp)
            assert row["lengths"][n] == tuple(lengths)
            assert row["iso_s"][n] == r_prefill_time(
                p70, demo.LONG_PROMPT, hw, tp, lengths=lengths)


def test_speculative_demo_equals_reference():
    pytest.importorskip("jax")
    from repro.config import Config as RConfig
    from repro.config import ParallelConfig as RParallelConfig
    from repro.serving import Engine as REngine
    from repro.serving import Request as RRequest
    from repro.serving.requests import SamplingParams as RSamplingParams
    demo = load("speculative_demo")
    rcfg = reference_twin(demo.CFG)
    ref_params, params = bridged_weights(rcfg)
    out = demo.run(params=params, device="cpu")

    config = RConfig(model=rcfg, parallel=RParallelConfig(data=1, model=1),
                     iso=reference_iso(demo.CONFIG.iso))
    assert out[0]["spec_accepted"] == 0
    assert out[3]["decode_calls"] < out[0]["decode_calls"]
    for spec_k in demo.SPEC_KS:
        eng = REngine(config, ref_params, mesh=None, max_batch=1,
                      max_len=256, bucket=16, spec_k=spec_k)
        rid = eng.add_request(RRequest(
            prompt=demo.prompt(), sampling=RSamplingParams(
                max_new_tokens=demo.NEW_TOKENS, eos_id=-1)))
        want = eng.run_until_complete()[rid]
        got = out[spec_k]
        assert got["tokens"] == want, spec_k
        assert (got["decode_calls"], got["spec_accepted"]) == \
            (eng.metrics["decode_calls"], eng.metrics["spec_accepted"])


@pytest.mark.parametrize("extra", [[], ["--paged"]], ids=["dense", "paged"])
def test_serve_batch_runs(extra, capsys):
    rc = load("serve_batch").main(["--device", "cpu", "--dtype", "float32"]
                                  + extra)
    assert rc == 0
    text = capsys.readouterr().out
    assert "arch=qwen3-4b" in text and "completed=5" in text


def test_train_small_runs_and_checkpoints(tmp_path, capsys):
    from repro_torch.config import get_model_config
    from repro_torch.launch.train import reduce_cfg
    from repro_torch.models import api
    from repro_torch.training import checkpoint
    from repro_torch.training.trainer import param_leaves
    ckpt = str(tmp_path / "ckpt")
    rc = load("train_small").main(["--device", "cpu", "--steps", "4",
                                   "--ckpt", ckpt])
    assert rc == 0
    rows = re.findall(r"^step\s+(\d+) loss (\S+) gnorm (\S+)",
                      capsys.readouterr().out, re.M)
    assert [int(s) for s, _, _ in rows] == [0, 3]
    assert all(math.isfinite(float(x)) for _, l, g in rows for x in (l, g))

    cfg = reduce_cfg(get_model_config("qwen3-4b"), "tiny")
    init = api.init_params(0, cfg, dtype=torch.bfloat16, device="cpu")
    tree, step = checkpoint.restore(ckpt, {"params": init})
    assert step == 4
    got, want = param_leaves(tree), param_leaves({"params": init})
    assert [g.name for g in got] == [w.name for w in want]
    moved = False
    for g, w in zip(got, want):
        for a, b in zip(g.tensors, w.tensors):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.isfinite(a.float()).all()
            moved |= not torch.equal(a, b)
    assert moved, "the checkpoint holds the untrained weights"
