"""Percentiles, censoring and rates over all requests of a window, and the
metric readers that use them, on a hand-made window."""
import importlib.util

import pytest

import harness
import stats
from conftest import BENCH


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_percentile_interpolates_over_all_values():
    xs = list(range(1, 101))                     # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_ttft_censors_at_the_close():
    assert stats.ttfts([0.0, 1.0, 2.0], [0.5, None, 2.25], 4.0) == \
        [0.5, 3.0, 0.25]


def test_gaps_inside_the_window_and_the_open_tail():
    stamps = [0.5, 1.0, 1.5, 3.0]
    assert stats.gaps(stamps, 1.0, 4.0, open_tail=False) == [0.5, 1.5]
    assert stats.gaps(stamps, 1.0, 4.0, open_tail=True) == [0.5, 1.5, 1.0]
    # a request that stalled through the whole window still counts
    assert stats.gaps([0.2], 1.0, 4.0, open_tail=True) == [pytest.approx(3.8)]


def test_rate():
    assert stats.rate(50, 2.0) == 25.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


class FakeCell:
    def __init__(self):
        self.cfg = {"num_hidden_layers": 1, "hidden_size": 8,
                    "num_attention_heads": 2, "num_key_value_heads": 1,
                    "head_dim": 4, "intermediate_size": 16,
                    "vocab_size": 32}


def make_run():
    """Window (10, 20]: r0 sent before the window, r1 and r2 inside it,
    r2 never sees its first token."""
    run = harness.Run(FakeCell())
    run.t0, run.t1 = 10.0, 20.0
    r0 = harness.Req(0, [1] * 100, 4, 8.0, 1)
    r0.stamps = [9.0, 11.0, 12.0, 13.0]
    r0.done = 13.0
    r1 = harness.Req(1, [1] * 40, 9, 13.0, 2)
    r1.stamps = [14.0, 15.0, 17.0]                 # still open at 20
    r2 = harness.Req(2, [1] * 10, 5, 16.0, 2)
    run.requests = [r0, r1, r2]
    return run


def test_readers_over_a_hand_made_window():
    run = make_run()
    # TTFT over requests sent in the window: r1 1.0 s, r2 censored 4.0 s
    assert reader("ttft_p90_ms").read(run) == \
        pytest.approx(1e3 * (1.0 + 0.9 * 3.0))
    # prompts of requests whose first token came in the window: r1 only
    assert reader("prompt_tokens_per_s").read(run) == pytest.approx(40 / 10)
    # tokens stamped in the window: r0's 3 and r1's 3
    assert reader("output_tokens_per_s").read(run) == pytest.approx(0.6)
    # gaps: r0 1, 1 (9 -> 11 began before the window); r1 1, 2, open 3
    gaps = sorted([1.0, 1.0, 1.0, 2.0, 3.0])
    assert reader("itl_p95_ms").read(run) == \
        pytest.approx(1e3 * stats.percentile(gaps, 95))


def test_counter_readers():
    run = make_run()
    run.c0 = dict(prefill_s=1.0, decode_s=2.0, prefill_tokens=100,
                  prefill_pad_tokens=20, decode_calls=10, steps=10)
    run.c1 = dict(prefill_s=3.0, decode_s=6.0, prefill_tokens=1100,
                  prefill_pad_tokens=270, decode_calls=110, steps=120)
    assert reader("pad_share.prefill").read(run) == pytest.approx(20.0)
    assert reader("prefill_ms_per_ktok").read(run) == pytest.approx(2000.0)
    assert reader("decode_step_ms").read(run) == pytest.approx(40.0)
    # 10 s of window less 2 s of prefill and 4 s of decode, over 110 steps
    assert reader("host_ms_per_step.decode").read(run) == \
        pytest.approx(1e3 * 4.0 / 110)


def test_trace_readers_return_nothing_without_a_trace():
    run = make_run()
    for name in ("idle_share.prefill", "idle_share.decode",
                 "paged_decode_roofline"):
        assert reader(name).read(run) is None
