"""The benchmark's operation and byte counts against figures worked out
by hand from the published sizes."""
import json

import pytest

import counts
from conftest import BENCH


def sizes(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return counts.Sizes(json.load(f))


# (matmul parameters, KV bytes a position): qwen3-8b a layer 4096 x 32 x
# 128 x 2 + 4096 x 8 x 128 x 2 + 3 x 4096 x 12288 = 192,937,984, x 36;
# qwen1.5-7b 4 x 4096^2 + 3 x 4096 x 11008 = 202,375,168, x 32
HAND = {"qwen3-8b": (6_945_767_424, 36 * 2 * 8 * 128 * 2),
        "qwen1.5-7b": (6_476_005_376, 32 * 2 * 32 * 128 * 2)}


@pytest.mark.parametrize("name", sorted(HAND))
def test_sizes_by_hand(name):
    s = sizes(name)
    params, kv = HAND[name]
    assert s.matmul_params == params
    assert s.kv_bytes_per_position == kv
    assert {"qwen3-8b": 147_456, "qwen1.5-7b": 524_288}[name] == kv


def test_flops_by_hand():
    s = sizes("qwen3-8b")
    head = 2 * 4096 * 151_936
    # decoding with the input at position 999 attends 1000 positions
    assert counts.decode_flops(s, 999) == \
        2 * 6_945_767_424 + 4 * 36 * 32 * 128 * 1000 + head
    assert counts.decode_flops(s, 999) == 15_726_018_560
    # a 4-token prompt attends 1 + 2 + 3 + 4 positions, the head once
    assert counts.prompt_flops(s, 4) == \
        2 * 6_945_767_424 * 4 + 4 * 36 * 32 * 128 * 10 + head
    assert counts.prompt_flops(s, 4) == 56_816_697_344


def test_paged_decode_bytes_by_hand():
    s = sizes("qwen1.5-7b")
    # 1000 resident positions of bf16 K and V, and per layer q (bf16) and
    # the fp32 output with its two statistics a head
    assert counts.paged_decode_bytes(s, 1000) == \
        1000 * 524_288 + 32 * (32 * 128 * 2 + 32 * 130 * 4)
    assert counts.paged_decode_bytes(s, 1000) == 525_082_624
    assert counts.paged_decode_flops(s, 1000) == 4 * 32 * 32 * 128 * 1000


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.roofline_seconds(989e12, 2 * 3.35e12) == \
        pytest.approx(2.0)
