"""The plain reference against the port at a tiny size on the CPU, in
float32: the port's prefill logits over a whole prompt, and the tokens the
port's engine served, read by the harness's own check."""
import json

import numpy as np
import pytest
import torch

import harness
import weights as weights_lib
from conftest import DATA
from reference import Reference

from repro_torch.config import ISOConfig, padded_vocab
from repro_torch.core.overlap import AxisCtx
from repro_torch.models import api


def tiny_cfg(**kw):
    with open(DATA / "configs" / "tiny-dense.json") as f:
        cfg = json.load(f)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("variant", [
    {}, {"qk_norm": False, "num_key_value_heads": 4},
    {"num_key_value_heads": 1}])
def test_reference_equals_the_ports_prefill(variant):
    cfg = tiny_cfg(**variant)
    mc = harness.model_config(cfg)
    params = weights_lib.make(cfg, 123, torch.device("cpu"),
                              padded_vocab(mc, 1), dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg["vocab_size"], size=600), dtype=torch.int32)
    out = api.prefill(params, mc, AxisCtx(), ISOConfig(),
                      {"tokens": toks[None]}, logits_mode="all")
    port = out["logits_local"][0, :, :cfg["vocab_size"]]
    rows = torch.arange(600)
    ref = Reference(cfg, params).logits([toks], [rows])[0]
    assert torch.allclose(port, ref, atol=2e-5, rtol=1e-4), \
        (port - ref).abs().max()


def test_fp8_control_differs_from_the_reference():
    cfg = tiny_cfg()
    mc = harness.model_config(cfg)
    params = weights_lib.make(cfg, 5, torch.device("cpu"),
                              padded_vocab(mc, 1), dtype=torch.float32)
    toks = torch.arange(2, 130, dtype=torch.int32)
    rows = torch.arange(128)
    ref = Reference(cfg, params).logits([toks], [rows])[0]
    ctl = Reference(cfg, params, precision="fp8").logits([toks], [rows])[0]
    err = (ref - ctl).abs().max()
    assert 1e-3 < err < 1.0, err


def test_served_tokens_agree_with_the_reference(tiny_root):
    """A whole tiny run on the CPU (the card's look skipped): the served
    tokens sit at the reference's best within float32 rounding."""
    root, manifest = tiny_root
    cell = harness.Cell("tiny-dense.tiny-chat", manifest, root)
    result, found = harness.run_cell(cell, 2 ** 31 + 99, 3.0, False, 0.0,
                                     device="cpu")
    assert result["correct"], found
    assert found["tokens"] >= cell.settings["check"]["tokens"]
    assert found["widest_gap"] < 1e-4
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
