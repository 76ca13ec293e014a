"""The port's performance model and ``auto`` split policy against the
reference's (``repro/perf/model.py``, ``repro/core/chunking.auto_split``):
exactly equal on the profiles both hold (the paper's A800 and 4090), the
paper's Table 1 bands on the port, the port's profiles (an H100, no TPU),
and an engine under ``split_policy="auto"`` giving the JAX engine's greedy
tokens under ``"even"`` (ISO invariance), its scheduler planning with the
decoder's tp."""
import dataclasses

import numpy as np
import pytest

from repro.config import get_model_config as r_get
from repro.core.chunking import auto_split as r_auto_split
from repro.perf import model as r_model

from repro_torch.config import ISOConfig, get_model_config
from repro_torch.configs import DENSE
from repro_torch.core.chunking import auto_split, split_chunks
from repro_torch.perf import model
from repro_torch.serving.scheduler import plan_chunks

SHARED = ("a800", "4090")
TPS = (1, 2, 4, 8, 16)
SEQS = (1024, 2048, 8192)


@pytest.mark.parametrize("hw", SHARED)
@pytest.mark.parametrize("name", DENSE)
def test_costs_and_tables_equal_reference(name, hw):
    cfg, rcfg = get_model_config(name), r_get(name)
    h, rh = model.HW_PROFILES[hw], r_model.HW_PROFILES[hw]
    assert dataclasses.astuple(h) == dataclasses.astuple(rh)
    for tp in TPS:
        for a, b in ((0, 1024), (512, 2048), (3000, 8192)):
            for int8 in (False, True):
                assert model.layer_costs(cfg, a, b, h, tp, int8) == \
                    r_model.layer_costs(rcfg, a, b, rh, tp, int8)
        for S in SEQS:
            assert model.prefill_time(cfg, S, hw, tp, iso=False) == \
                r_model.prefill_time(rcfg, S, hw, tp, iso=False)
            lengths = [S // 2 - 128, S // 2 + 128]
            assert model.prefill_time(cfg, S, hw, tp, lengths=lengths) == \
                r_model.prefill_time(rcfg, S, hw, tp, lengths=lengths)
        for int8 in (False, True):
            assert model.speedup_table(cfg, hw, tp, SEQS, int8_comm=int8) \
                == r_model.speedup_table(rcfg, hw, tp, SEQS, int8_comm=int8)


@pytest.mark.parametrize("hw", SHARED)
@pytest.mark.parametrize("name", DENSE)
def test_auto_split_equals_reference(name, hw):
    """Tuple for tuple, tp=1 included, where every candidate costs the same
    in exact arithmetic and rounding picks the winner."""
    cfg, rcfg = get_model_config(name), r_get(name)
    for tp in TPS:
        for S in SEQS:
            assert auto_split(S, 2, cfg, hw_name=hw, tp=tp) == \
                r_auto_split(S, 2, rcfg, hw_name=hw, tp=tp), (tp, S)


def test_table1_bands_hold_on_the_port():
    """The reference's test_table1_bands: ~35% average prefill reduction on
    the 4090 (int8 comm, paper-30b at tp=4), ~15% on the A800 (paper-70b at
    tp=8), for prompts >= 4k."""
    lengths = [4096, 8192, 16384, 32768]
    r30 = model.speedup_table(get_model_config("paper-30b"), "4090", 4,
                              lengths, int8_comm=True)
    r70 = model.speedup_table(get_model_config("paper-70b"), "a800", 8,
                              lengths)
    assert 25.0 <= sum(r30.values()) / len(r30) <= 50.0, r30
    assert 5.0 <= sum(r70.values()) / len(r70) <= 25.0, r70


def test_profiles_hold_an_h100_and_no_tpu():
    assert set(model.HW_PROFILES) == {"h100", "a800", "4090"}
    assert model.DEFAULT_HW == "h100"
    h = model.HW_PROFILES["h100"]
    assert h.name == "h100" and h.flops > 0 and h.hbm_bw > 0
    assert h.link_bw == 450e9 and h.comm_penalty == 0.18
    with pytest.raises(KeyError):
        model.prefill_time(get_model_config("paper-30b"), 2048, "v5e", 1)


@pytest.mark.parametrize("tp", [1, 4])
def test_split_chunks_auto_runs_on_the_h100_profile(tp):
    cfg = get_model_config("qwen3-32b")
    iso = ISOConfig(split_policy="auto")
    for S in SEQS:
        got = split_chunks(S, iso, cfg, tp=tp)
        assert got == auto_split(S, 2, cfg, hw_name="h100", tp=tp)
        assert sum(got) == S and all(c % 128 == 0 for c in got)
        assert plan_chunks(S, iso, cfg, tp=tp) == got
    # tp changes the answer on this profile, which is why the scheduler
    # takes the engine's tp rather than a default
    assert split_chunks(2048, iso, cfg, tp=1) != \
        split_chunks(2048, iso, cfg, tp=4)


def test_engine_auto_split_tokens_equal_jax_even(monkeypatch):
    """A tiny twin engine under ``auto`` gives the JAX engine's greedy
    tokens under ``even`` on mixed traffic with resumed grants; its
    scheduler and its decoder split a whole-prompt grant the same way."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_torch_layouts import MIXED, REF_ISO, TWINS, _prompts, \
        port_cfg, run_port, run_reference
    from repro.models import api as r_api
    from repro_torch import bridge
    from repro_torch.models import decoder
    from repro_torch.serving import scheduler

    rcfg = TWINS["mha4_noqk_rope1e4"]
    cfg = port_cfg(rcfg)
    ref = r_api.init_params(jax.random.PRNGKey(0), rcfg, tp=1,
                            dtype=jnp.float32)
    params = bridge.from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                   device="cpu")
    auto = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8,
                     chunk_align=8, split_policy="auto")
    lengths, seed, new, sv = MIXED
    prompts = _prompts(lengths, seed) + _prompts((64,), 9)
    sv = dict(sv, prefill_token_budget=64)
    want, _ = run_reference(rcfg, ref, prompts, new, sv, iso=REF_ISO)
    calls = []

    def recorder(site, fn):
        def split(S, iso_c, c, **kw):
            out = fn(S, iso_c, c, **kw)
            calls.append((site, S, kw.get("tp"), out))
            return out
        return split

    monkeypatch.setattr(scheduler, "split_chunks",
                        recorder("scheduler", scheduler.split_chunks))
    monkeypatch.setattr(decoder, "split_chunks",
                        recorder("decoder", decoder.split_chunks))
    got, eng = run_port(cfg, params, prompts, new, sv, iso=auto)
    assert got == want
    assert all(tp == eng.tp == 1 for _, _, tp, _ in calls)
    plans = {(site, S): chunks for site, S, _, chunks in calls}
    assert plans[("scheduler", 64)] == plans[("decoder", 64)] == \
        auto_split(64, 2, cfg, tp=1, align=8)
    # the invariance is not vacuous: some planned split is not the even one
    even = dataclasses.replace(auto, split_policy="even")
    assert any(chunks != split_chunks(S, even, cfg)
               for _, S, _, chunks in calls)
