"""The parameter bridge, the port's isolation from JAX and from the JAX
package, its device rule (CUDA unless the CPU is asked for), the settings
outside its slice, the reference's default serving features, and the
launcher end to end on the CPU."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.config import Config, ModelConfig, ParallelConfig, \
    ServingConfig, get_model_config
from repro_torch.models import api
from repro_torch.serving import PagedEngine

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's examples/<name>_torch.py scripts
EXAMPLES = ("quickstart", "iso_prefill_demo", "serve_batch",
            "speculative_demo", "train_small")
TINY = ModelConfig(name="t-dense", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                   qk_norm=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from conftest import tiny_dense
    from repro.models import api as r_api
    ref = r_api.init_params(jax.random.PRNGKey(3), tiny_dense(), tp=1,
                            dtype=getattr(jnp, dtype))
    host = jax.tree_util.tree_map(np.asarray, ref)
    params = bridge.from_reference(host)
    # unstacked: one dict per layer, the padded head-slot layout kept
    assert len(params["periods"]) == 1 and len(params["periods"][0]) == 2
    layer = params["periods"][0][1]
    assert layer["attn"]["wq"].shape == (64, 4, 16)
    assert layer["attn"]["wq"].dtype == getattr(torch, dtype)
    assert layer["norm1"]["scale"].dtype == torch.float32
    back = bridge.to_reference(params)
    flat_a, tree_a = jax.tree_util.tree_flatten(host)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_port_imports_without_jax_or_reference():
    """Every repro_torch module imports with JAX and the JAX package made
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 25


def test_no_jax_or_reference_imports_in_port_sources():
    bad = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro[ .])",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        [ROOT / "examples" / f"{name}_torch.py" for name in EXAMPLES]
    assert len(files) > 25
    for f in files:
        text = f.read_text()
        hits = [m.group(0) for m in bad.finditer(text)]
        assert not hits, (f, hits)


def _config(**sv):
    base = dict(page_size=8, max_batch=2, max_len=64, prefix_sharing=False,
                prefill_batching=False)
    base.update(sv)
    return Config(model=TINY, parallel=ParallelConfig(data=1, model=1),
                  serving=ServingConfig(**base))


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """Without device="cpu" the entry points want CUDA and raise when it is
    absent, instead of quietly running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = api.init_params(0, TINY, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(_config(), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(0, TINY, dtype=torch.float32)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-8b", "--paged"])
    # each example script, loaded by path, at its defaults
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])
    PagedEngine(_config(), params, device="cpu")           # asked: fine


@pytest.mark.parametrize("setting,model,item", [
    # disaggregated serving is in the slice at tp=1 and under TP: a phase
    # engine builds on a TP group; the router under TP takes the two rank
    # groups of a DisaggGroup, and a lone TPGroup raises
    pytest.param(dict(disagg=True), {}, "DisaggGroup",
                 id="setting0-model0-item 15"),
    # the cost model under TP too; a recurrent stack never migrates
    pytest.param(dict(disagg=True, cost_table="auto"),
                 dict(block_pattern=("hybrid",)), "recurrent",
                 id="setting1-model1-item 15"),
    # every family the reference registers is in the slice (the VLM since
    # its patches were ported); a family it does not know raises
    ({}, dict(family="vision"), "not ported"),
])
def test_settings_outside_the_slice_raise(setting, model, item):
    from repro_torch.launch.mesh import TPGroup
    from repro_torch.serving.disagg import DisaggRouter
    params = api.init_params(0, TINY, dtype=torch.float32, device="cpu")
    config = _config(**setting)
    if setting.get("disagg"):
        PagedEngine(config, params, device="cpu")       # tp=1: fine
        group = TPGroup(rank=0, tp=2, device=torch.device("cpu"),
                        backend="gloo")
        tp2 = dataclasses.replace(config, parallel=ParallelConfig(data=1,
                                                                  model=2))
        shard = api.init_params(0, TINY, tp=2, rank=0, dtype=torch.float32,
                                device="cpu")
        for phase in ("prefill", "decode"):
            eng = PagedEngine(tp2, shard, mesh=group, phase=phase)
            assert eng.phase == phase and eng.tp == 2
            assert eng.kv.k[0].shape[-2] == TINY.num_kv_heads // 2
        bad = dataclasses.replace(tp2, model=dataclasses.replace(
            tp2.model, **model))
        with pytest.raises(TypeError if item == "DisaggGroup"
                           else AssertionError, match=item):
            DisaggRouter(bad, shard, mesh=group)
    else:
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, **model))
        with pytest.raises(NotImplementedError, match=item):
            PagedEngine(config, params, device="cpu")
    # tensor parallelism is in the slice: the mesh is a launch.mesh.TPGroup
    with pytest.raises(TypeError, match="TPGroup"):
        PagedEngine(_config(), params, device="cpu", mesh=object())


@pytest.mark.parametrize("setting", [
    dict(prefix_sharing=True), dict(prefill_batching=True), dict(spec_k=2),
    dict(prefix_sharing=True, prefill_batching=True, spec_k=3)],
    ids=["prefix_sharing", "prefill_batching", "spec_k", "all"])
def test_serving_features_construct_and_serve(setting):
    """The reference's default serving features run in the port: the engine
    takes each and serves two greedy requests with a common prompt head."""
    from repro_torch.serving import Request
    from repro_torch.serving.requests import SamplingParams
    params = api.init_params(0, TINY, dtype=torch.float32, device="cpu")
    eng = PagedEngine(_config(max_len=80, **setting), params, device="cpu")
    rng = np.random.default_rng(0)
    head = rng.integers(2, 64, 20).astype(np.int32)
    rids = [eng.add_request(Request(
        prompt=np.concatenate([head, rng.integers(2, 64, n)]).astype(
            np.int32), sampling=SamplingParams(max_new_tokens=6, eos_id=-1)))
        for n in (3, 5)]
    outs = eng.run_until_complete()
    assert [len(outs[r]) for r in rids] == [6, 6]
    assert eng.alloc.free_pages == eng.alloc.num_pages
    m = eng.metrics
    assert (m["prefix_shared_tokens"] > 0) == eng.sv.prefix_sharing
    # packed closures are keyed (bucket, rows, all_fresh)
    assert all(len(k) == (3 if eng.sv.prefill_batching else 2)
               for k in eng._prefill_fns)
    assert (m["spec_calls"] > 0) == bool(eng.sv.spec_k)


def test_qwen3_8b_config_and_full_size_shapes():
    cfg = get_model_config("qwen3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (36, 4096, 32, 8, 128, 12288, 151936)
    assert 8.0e9 < cfg.param_count() < 8.4e9
    # the KV cost per token the card must hold (bf16, k and v, all layers)
    assert 2 * cfg.num_layers * cfg.num_kv_heads * 128 * 2 == 147456
    small = dataclasses.replace(cfg, num_layers=1, d_model=128, d_ff=256,
                                vocab_size=100)
    p = api.init_params(0, small, device="cpu")
    assert p["periods"][0][0]["attn"]["wq"].shape == (128, 32, 128)
    assert p["embed"]["table"].shape == (2048, 128)
    assert p["embed"]["table"].dtype == torch.bfloat16


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3-8b", "--preset", "tiny", "--paged",
                       "--device", "cpu", "--dtype", "float32",
                       "--requests", "3", "--prompt-len", "40",
                       "--max-new", "4", "--prefill-budget", "16"]) == 0
    out = capsys.readouterr().out
    assert "completed=3" in out and "resumed=" in out
