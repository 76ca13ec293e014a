"""The port's serving launcher's flags of disaggregation, the decode
schedules, the overlap probe and the traffic (after
``repro/launch/serve.py``), on the tiny twins on the CPU, as
tests/test_torch_configs.py tests ``--arch``:

  * ``--arch ladder-qwen3-8b`` serves on the ladder decode stack, and
    ``--decode-schedule`` runs each schedule it names;
  * ``--disagg --decode-pool-pages N --migrate-batch 1`` serves through the
    router, one request a transfer, with the single engine's tokens;
  * ``--probe-overlap`` prints the probe's schedules, ``--shared-prefix``
    shares pages, ``--temperature`` samples;
  * the reference's argument errors: ``--spec-k`` with ``--temperature >
    0``, ``--disagg`` with ``--probe-overlap`` or ``--autotune``, the
    disagg sizes without ``--disagg``, and a ladder schedule on a
    standard-wired arch;
  * without ``--paged`` the dense Engine serves (``--spec-k`` included),
    and the flags it has no use for (``--probe-overlap``, ``--autotune``,
    ``--cost-table``, ``--disagg``, ``--tp > 1``, ``--decode-schedule``)
    are errors."""
import re

import pytest
import torch

from repro_torch.launch import serve

torch.set_num_threads(1)

BASE = ["--preset", "tiny", "--paged", "--device", "cpu", "--dtype",
        "float32", "--requests", "3", "--prompt-len", "40", "--max-new", "4",
        "--prefill-budget", "16"]


def _run(capsys, *args):
    assert serve.main(list(args) + BASE) == 0
    return capsys.readouterr().out


def _tokens(out):
    return re.findall(r"rid \d+: (\[.*\])", out)


def test_ladder_arch_serves_on_the_ladder_decode_stack(capsys):
    out = _run(capsys, "--arch", "ladder-qwen3-8b")
    assert "arch=ladder-qwen3-8b" in out and "completed=3" in out
    assert "decode_schedule=ladder {'ladder':" in out


@pytest.mark.parametrize("arch,schedule", [
    ("qwen3-8b", "sequential"), ("qwen3-8b", "batch_split"),
    ("qwen3-8b", "cross_block"), ("ladder-qwen3-8b", "ladder"),
    ("ladder-qwen3-8b", "ladder_seq")])
def test_decode_schedule_flag(capsys, arch, schedule):
    out = _run(capsys, "--arch", arch, "--decode-schedule", schedule)
    assert f"decode_schedule={schedule} " in out and "completed=3" in out


def test_disagg_flags_serve_the_single_engine_tokens(capsys):
    single = _tokens(_run(capsys, "--arch", "qwen3-8b"))
    out = _run(capsys, "--arch", "qwen3-8b", "--disagg",
               "--decode-pool-pages", "20", "--migrate-batch", "1")
    assert "arch=qwen3-8b disagg" in out and "completed=3" in out
    assert re.search(r"migration: transfers=3 requests=3 pages=\d+", out)
    assert _tokens(out) == single


def test_probe_overlap_flag(capsys):
    out = _run(capsys, "--arch", "qwen3-8b", "--probe-overlap")
    assert "overlap probe: efficiency=" in out and "(proxy)" in out
    for name in ("sequential", "batch_split", "ladder", "cross_block"):
        assert f"schedule {name}" in out


def test_shared_prefix_and_temperature(capsys):
    out = _run(capsys, "--arch", "qwen3-8b", "--shared-prefix", "32")
    assert int(re.search(r"prefix_shared_tokens=(\d+)", out).group(1)) > 0
    greedy = _tokens(_run(capsys, "--arch", "qwen3-8b"))
    sampled = _tokens(_run(capsys, "--arch", "qwen3-8b", "--temperature",
                           "5.0"))
    assert sampled != greedy and len(sampled) == len(greedy)


def test_dense_engine_without_paged(capsys):
    """Without ``--paged`` the dense Engine serves, a verify window
    included, with the greedy tokens of the plain run."""
    dense = BASE[:2] + BASE[3:]
    assert serve.main(["--arch", "qwen3-8b"] + dense) == 0
    plain = capsys.readouterr().out
    assert "arch=qwen3-8b engine=dense" in plain and "completed=3" in plain
    assert serve.main(["--arch", "qwen3-8b", "--spec-k", "3"] + dense) == 0
    spec = capsys.readouterr().out
    assert re.search(r"spec: spec_calls=[1-9]", spec)
    assert _tokens(spec) == _tokens(plain)


@pytest.mark.parametrize("args,msg", [
    # the dense Engine's rules, as the reference's launcher
    (["--probe-overlap"], "--probe-overlap requires --paged"),
    (["--autotune"], "require --paged"),
    (["--cost-table", "auto"], "require --paged"),
    (["--disagg"], "--disagg requires --paged"),
    (["--tp", "2"], "--tp requires --paged"),
    (["--decode-schedule", "sequential"], "requires --paged")])
def test_dense_engine_argument_errors(capsys, args, msg):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "qwen3-8b", "--preset", "tiny", "--device",
                    "cpu"] + args)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("args,msg", [
    (["--spec-k", "2", "--temperature", "0.5"], "greedy-only"),
    (["--disagg", "--probe-overlap"], "does not combine"),
    (["--disagg", "--autotune"], "does not combine"),
    (["--decode-pool-pages", "8"], "require --disagg"),
    (["--migrate-batch", "1"], "require --disagg"),
    (["--decode-schedule", "ladder"], "needs a ladder arch")])
def test_argument_errors(capsys, args, msg):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "qwen3-8b"] + args + BASE)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err
