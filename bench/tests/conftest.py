"""The port benchmark's CPU tests: ``python -m pytest bench/tests`` from the
repository root.  Tests that need a card carry the ``card`` marker and skip
inside their fixture when no card is visible."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELL = "tiny-dense.tiny-chat"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
    # the tiny runs are timed windows: one intra-op thread keeps their
    # pace when other processes hold the cores
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the chip")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark data root holding the tiny test cell's files beside the
    real metric readers, and its manifest."""
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "cells"):
        shutil.copytree(DATA / sub, root / sub)
    shutil.copytree(BENCH / "metrics", root / "metrics")
    with open(DATA / "manifest.json") as f:
        return root, json.load(f)
