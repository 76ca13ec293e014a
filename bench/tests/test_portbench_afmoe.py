"""The afmoe configuration's benchmark files: ``counts_afmoe`` against
figures worked out by hand (at the tiny twin's sizes and at Trinity-Mini's),
the plain reference's imports, the routed experts' draw, the new
configuration, traffic and cell loading through ``harness.Cell``, and a
whole tiny run on the CPU with the fp8 control beside it."""
import json
import shutil

import pytest
import torch

import counts_afmoe
import harness
import traffic
import weights_afmoe
from conftest import BENCH, DATA, REPO
from test_portbench_imports import FORBIDDEN, imported_tops


def tiny():
    with open(DATA / "configs" / "tiny-afmoe.json") as f:
        return counts_afmoe.Sizes(json.load(f))


def test_tiny_counts_by_hand():
    s = tiny()
    # a layer: q, o, gate 64 x 64 each, k, v 64 x 32 each; 2 dense layers
    # of 3 x 64 x 96; 6 MoE layers: router 64 x 8, 2 routed and 1 shared
    # expert of 3 x 64 x 32
    attn = 3 * 64 * 64 + 2 * 64 * 32
    assert s.matmul_params == 8 * attn + 2 * 3 * 64 * 96 + \
        6 * (64 * 8 + 3 * 3 * 64 * 32)
    assert s.matmul_params == 8 * 16384 + 36864 + 6 * 18944 == 281600
    # position 30 attends 31 positions on the 2 full layers, the window's
    # 16 on the 6 sliding ones; position 5 attends 6 everywhere
    assert counts_afmoe.attended(s, 30) == 2 * 31 + 6 * 16
    assert counts_afmoe.attended(s, 5) == 8 * 6
    head = 2 * 64 * 512
    assert counts_afmoe.decode_flops(s, 30) == \
        2 * 281600 + 4 * 4 * 16 * 158 + head
    # a 20-token prompt: 210 pairs on a full layer; on a sliding one
    # 1 + ... + 16 = 136 and 4 more rows of 16
    assert counts_afmoe.prompt_flops(s, 20) == \
        2 * 281600 * 20 + 4 * 4 * 16 * (2 * 210 + 6 * (136 + 64)) + head


def test_moe_call_counts_by_hand():
    s = tiny()
    # one token reaches its k = 2 of 8 experts; 3 tokens 8 (1 - (3/4)^3)
    assert counts_afmoe.experts_reached(s, 1) == pytest.approx(2.0)
    assert counts_afmoe.experts_reached(s, 3) == pytest.approx(8 * 37 / 64)
    expert = 3 * 64 * 32 * 2                       # bf16 bytes an expert
    assert counts_afmoe.moe_call_bytes(s, 3) == pytest.approx(
        8 * 37 / 64 * expert + 2 * 3 * 64 * 2)
    assert counts_afmoe.moe_call_flops(s, 3) == 2 * 3 * 2 * 3 * 64 * 32


def test_trinity_mini_by_hand():
    with open(BENCH / "configs" / "trinity-mini.json") as f:
        s = counts_afmoe.Sizes(json.load(f))
    # 32 layers of q, o, gate 2048 x 4096 and k, v 2048 x 512; 2 dense of
    # 3 x 2048 x 6144; 30 MoE of router 2048 x 128 and 9 experts of
    # 3 x 2048 x 1024
    assert s.matmul_params == 32 * (3 * 2048 * 4096 + 2 * 2048 * 512) + \
        2 * 3 * 2048 * 6144 + 30 * (2048 * 128 + 9 * 3 * 2048 * 1024)
    assert (s.full_layers, s.moe_layers, s.window) == (8, 30, 2048)
    # a decode step's 22 tokens reach ~97 of 128 experts a layer
    assert counts_afmoe.experts_reached(s, 22) == pytest.approx(97.06, 1e-3)
    assert counts_afmoe.attended(s, 4999) == 8 * 5000 + 24 * 2048


def test_reference_imports_nothing_of_the_program():
    for name in ("reference_afmoe.py", "counts_afmoe.py",
                 "weights_afmoe.py"):
        tops = imported_tops(BENCH / name)
        assert "repro_torch" not in tops and not tops & FORBIDDEN, name


def test_routed_experts_share_a_common_draw():
    """Each routed expert keeps its leaf's scale and shares 1 - a^2 of its
    variance with the layer's other experts; the shared expert, the dense
    layers and the attention are independent draws."""
    with open(DATA / "configs" / "tiny-afmoe.json") as f:
        cfg = json.load(f)
    cfg.update(num_experts=64, moe_intermediate_size=128)
    p = weights_afmoe.make(cfg, 2 ** 31 + 3, "cpu", 512, torch.float32)
    a = weights_afmoe.EXPERT_SPREAD
    out = 0.02 / (2 * cfg["num_hidden_layers"]) ** 0.5
    moe = p["periods"][5][0]["moe"]
    for name, std in (("w_up", 0.02), ("w_gate", 0.02), ("w_down", out)):
        w = moe[name].reshape(64, -1)
        assert w.std().item() == pytest.approx(std, rel=0.05), name
        corr = torch.corrcoef(w)[~torch.eye(64, dtype=torch.bool)]
        assert corr.mean().item() == pytest.approx(1 - a * a, abs=0.02)
    for w in (moe["shared"]["w_up"].T, p["periods"][0][0]["mlp"]["w_up"].T):
        corr = torch.corrcoef(w)[~torch.eye(len(w), dtype=torch.bool)]
        assert abs(corr.mean().item()) < 0.02
    # another layer's experts gather around another matrix
    other = p["periods"][6][0]["moe"]["w_up"].reshape(64, -1)
    mine = moe["w_up"].reshape(64, -1)
    assert abs(torch.corrcoef(torch.stack([mine[0], other[0]]))[0, 1]) < 0.05


def test_new_files_load_through_the_harness():
    with open(REPO / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cell = harness.Cell("trinity-mini.mixed-chat", manifest)
    assert cell.cfg["num_experts"] == 128 and cell.cfg["reduced"] == []
    assert cell.mix["clients"] == 24 and cell.settings["engine"] == {
        "max_batch": 24, "max_len": 8192, "prefill_token_budget": 1024}
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"itl_p97_ms", "output_tokens_per_s", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert {"moe_decode_roofline", "mfu.decode.moe",
            "prefill_ms_per_ktok.decode"} <= layer
    assert not {"mfu.decode", "paged_decode_roofline"} & layer
    # about 37 % of the prompts past the 2,048 window, none past max_len
    prompts = traffic.quantiles(cell.mix["prompt"], 64)
    assert 0.3 < (prompts > 2048).mean() < 0.45
    assert prompts.max() + cell.mix["output"]["max"] <= 8192


@pytest.fixture
def afmoe_root(tmp_path):
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "cells"):
        shutil.copytree(DATA / sub, root / sub)
    shutil.copytree(BENCH / "metrics", root / "metrics")
    with open(DATA / "manifest_afmoe.json") as f:
        return root, json.load(f)


def test_tiny_run_and_its_control(afmoe_root):
    """A whole tiny afmoe run on the CPU: the served tokens are the
    reference's best within float32 rounding; under the fp8 control the
    reference's own first tokens lie further below than the limit."""
    root, manifest = afmoe_root
    cell = harness.Cell("tiny-afmoe.tiny-chat", manifest, root)
    result, found = harness.run_cell(cell, 2 ** 31 + 7, 2.0, True, 0.0,
                                     device="cpu")
    assert result["correct"], found
    assert found["widest_gap"] < 1e-4
    # the card's readers find nothing on the CPU; the host clock's does
    assert "moe_decode_roofline" not in result["metrics"]
    assert result["metrics"]["mfu.decode.moe"]["value"] > 0
    # the grant calls' time a thousand prompt tokens, as prefill_ms_per_ktok
    grant = result["metrics"]["prefill_ms_per_ktok.decode"]["value"]
    assert grant == result["metrics"]["prefill_ms_per_ktok"]["value"] > 0
    result, found = harness.run_cell(cell, 11, 2.0, False, 0.0,
                                     device="cpu", control=True)
    assert not result["correct"] and found["program_widest_gap"] < 1e-4
