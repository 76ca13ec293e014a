"""The correctness check catches a broken timed path: a whole tiny run on
the CPU (the card's look skipped) with a fault planted under the engine,
and the fp8 control put in the program's place, each seen as not correct.
The faults a served cell can have: a token altered where it is produced,
and a decode step that leaves its state (the KV pools) unchanged."""
import numpy as np
import pytest

import harness
from repro_torch.models import api
from repro_torch.serving import paged_engine


def run_tiny(tiny_root, seed=2 ** 31 + 3, control=False):
    root, manifest = tiny_root
    cell = harness.Cell("tiny-dense.tiny-chat", manifest, root)
    return harness.run_cell(cell, seed, 3.0, False, 0.0, device="cpu",
                            control=control)


def test_sound_run_is_correct(tiny_root):
    result, found = run_tiny(tiny_root)
    assert result["correct"], found


def test_altered_token_is_caught(tiny_root, monkeypatch):
    def altered(logits, sp, step):
        return (int(np.argmax(logits)) + 1) % len(logits)

    monkeypatch.setattr(paged_engine, "sample", altered)
    result, found = run_tiny(tiny_root)
    assert not result["correct"], found
    assert found["widest_gap"] > result["checks"]["widest_gap"]["limit"]


def test_decode_that_keeps_its_state_is_caught(tiny_root, monkeypatch):
    real = api.decode_step

    def stateless(params, cfg, ctx, tokens, caches, *a, **kw):
        caches = tuple({k: (v.clone() if k in ("k_pages", "v_pages") else v)
                        for k, v in c.items()} for c in caches)
        return real(params, cfg, ctx, tokens, caches, *a, **kw)

    monkeypatch.setattr(api, "decode_step", stateless)
    result, found = run_tiny(tiny_root)
    assert not result["correct"], found


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_fp8_control_fails_the_limit(tiny_root, seed):
    """The control, the reference in float8 put in the program's place, is
    not correct: its widest gap passes the limit that the program's own
    reading, kept beside it, stays under."""
    result, found = run_tiny(tiny_root, seed=seed, control=True)
    limit = result["checks"]["widest_gap"]["limit"]
    assert result["correct"] is False, found
    assert result["checks"]["widest_gap"]["value"] == found["widest_gap"]
    assert found["program_widest_gap"] <= limit < found["widest_gap"], found
