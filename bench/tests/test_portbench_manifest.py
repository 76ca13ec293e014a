"""BENCHMARK.json keeps to its contract, every cell finds its files, and a
cell added as files and a manifest entry alone is found and runs."""
import json
import re

import pytest

import harness
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head_dim|_dim$"
                    r"|_rank$|expansion|experts_per_tok)")


@pytest.fixture(scope="module")
def manifest():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["bench"]
    assert manifest["command"] == ["python3", "bench/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in manifest[k]]
    assert len(set(metrics)) == len(metrics)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_finds_its_files_and_reports_enough(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        cell = harness.Cell(w["name"], manifest)
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer + cell.end_to_end:
            assert hasattr(cell.reader(m["name"]), "read")
            assert cell.reader(m["name"]).SOURCE == m["source"]
        for m in cell.per_layer:
            assert m["moves"] in got and applies_to(e2e[m["moves"]], w)


def applies_to(metric, workload):
    return harness.applies(metric, workload["name"])


def test_configs_hold_their_sizes(manifest):
    for c in manifest["configs"]:
        path = REPO / c["file"]
        assert path == BENCH / "configs" / f"{c['name']}.json"
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert not any(WIDTHS.search(k) for k in c["reduced"])


def test_a_cell_added_as_files_alone_is_found(tiny_root, manifest):
    """A new traffic mix, cell file and manifest entry, with no code: the
    harness finds and runs it (on the CPU, the card's look skipped)."""
    root, tiny = tiny_root
    mix = json.loads((root / "traffic" / "tiny-chat.json").read_text())
    mix.update(name="tiny-burst", clients=2)
    (root / "traffic" / "tiny-burst.json").write_text(json.dumps(mix))
    cell = json.loads((root / "cells" / "tiny-dense.tiny-chat.json")
                      .read_text())
    cell.update(name="tiny-dense.tiny-burst")
    (root / "cells" / "tiny-dense.tiny-burst.json").write_text(
        json.dumps(cell))
    tiny["workloads"].append({"name": "tiny-dense.tiny-burst",
                              "config": "tiny-dense", "traffic": "tiny-burst",
                              "chips": 1, "why": "added as files"})
    found = harness.Cell("tiny-dense.tiny-burst", tiny, root)
    assert found.mix["clients"] == 2
    result, readings = harness.run_cell(found, 42, 3.0, True, 0.0,
                                        device="cpu")
    assert result["correct"], readings
    assert set(result["metrics"]) <= {m["name"] for m in found.per_layer}
    assert "pad_share.prefill" in result["metrics"]


def test_a_family_added_as_modules_is_loaded_by_name(tiny_root, tmp_path,
                                                     monkeypatch):
    """A configuration names its port, weights and reference modules; the
    harness loads them by those names, so a new model family adds modules
    and files and edits none."""
    code = tmp_path / "code"
    code.mkdir()
    (code / "twin_port.py").write_text(
        "import port_dense\nCALLS = []\n"
        "def model_config(cfg):\n"
        "    CALLS.append(cfg['name'])\n"
        "    return port_dense.model_config(dict(cfg, family='dense'))\n")
    (code / "twin_weights.py").write_text(
        "import weights\nCALLS = []\n"
        "def make(cfg, *a, **kw):\n"
        "    CALLS.append(cfg['name'])\n"
        "    return weights.make(cfg, *a, **kw)\n")
    (code / "twin_reference.py").write_text(
        "import reference\nCALLS = []\n"
        "class Reference(reference.Reference):\n"
        "    def __init__(self, cfg, *a, **kw):\n"
        "        CALLS.append(cfg['name'])\n"
        "        super().__init__(cfg, *a, **kw)\n")
    monkeypatch.syspath_prepend(str(code))
    root, tiny = tiny_root
    cfg = json.loads((root / "configs" / "tiny-dense.json").read_text())
    cfg.update(name="tiny-twin", family="twin", port="twin_port",
               weights="twin_weights", reference="twin_reference")
    (root / "configs" / "tiny-twin.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "cells" / "tiny-dense.tiny-chat.json")
                      .read_text())
    cell.update(name="tiny-twin.tiny-chat")
    (root / "cells" / "tiny-twin.tiny-chat.json").write_text(json.dumps(cell))
    tiny["workloads"].append({"name": "tiny-twin.tiny-chat",
                              "config": "tiny-twin", "traffic": "tiny-chat",
                              "chips": 1, "why": "added as modules"})
    found = harness.Cell("tiny-twin.tiny-chat", tiny, root)
    result, readings = harness.run_cell(found, 7, 3.0, False, 0.0,
                                        device="cpu")
    assert result["correct"], readings
    import twin_port
    import twin_reference
    import twin_weights
    for mod in (twin_port, twin_weights, twin_reference):
        assert mod.CALLS and set(mod.CALLS) == {"tiny-twin"}, mod.__name__
    with pytest.raises(ValueError):
        harness.module("../weights")
