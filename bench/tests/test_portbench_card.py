"""On the card: one short run of a cell through the entry point, as the
benchmark's check runs it, prints a correct result whose device is the
card.  Skips without a card."""
import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.card
def test_short_run_prints_a_correct_result(card):
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen3-8b.chat-decode", "--seed", str(2 ** 31 + 17), "--seconds",
         "3", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], res.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"itl_p95_ms", "output_tokens_per_s",
                                    "setup_s"}
