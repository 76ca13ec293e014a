"""Nothing under bench/ imports JAX or the JAX package ``repro``, judged by
the top-level name of each module (``repro_torch`` begins with ``repro``
but is another name), and the plain reference imports nothing of the
program at all."""
import ast
import sys
import types

import pytest

import harness
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = imported_tops(path) & FORBIDDEN
        assert not bad, (path, bad)


@pytest.mark.parametrize("name", ["reference.py", "counts.py",
                                  "weights.py", "stats.py", "traffic.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported_tops(BENCH / name)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_sub",
                        types.ModuleType("repro_torch_fake_sub"))
    monkeypatch.setitem(sys.modules, "reprox.y", types.ModuleType("reprox.y"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.config",
                        types.ModuleType("repro.config"))
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "repro"]
