"""The int8 quantize kernels' launch plan (``native.row_plan``), in numbers:
pure Python, no card.  Serving rows keep the warp-a-row or block-a-row
choice the kernels have always made; a row too long for its rows' blocks to
fill the card (the gradient mean's ``dp`` rows of a flattened leaf) is cut
into segments of whole vectors that cover it exactly once; an unaligned or
odd-width long row splits on the scalar path; a width or row count of 2^31
or more, which ctypes would cut to 32 bits, raises."""
import pytest

from repro_torch.kernels import native

BF16, FP32, INT8 = 2, 4, 1
# the gradient mean's rows at dp=2: internvl2-2b's padded embedding table,
# flattened and halved
GRAD_ROW = 96_468_992

# (label, rows, d, element bytes, vector bytes, aligned) -> (vec, mode):
# the int8 reduce cases of chip_smoke.py's phase 2 as each kernel sees them
# (quantize_int8_shards: rows R * tp of D / tp; dequant_sum_quantize_int8:
# R rows of int8 in 8-byte vectors), B7 and RMSNorm at (2048, 4096)
SERVING = [
    ("shards (4, 4096) tp2 bf16", 8, 2048, BF16, 16, True, (True, "block")),
    ("shards (4, 4096) tp2 fp32", 8, 2048, FP32, 16, True, (True, "block")),
    ("shards (4, 4096) tp4 bf16", 16, 1024, BF16, 16, True, (True, "warp")),
    ("shards (4, 4096) tp4 fp32", 16, 1024, FP32, 16, True, (True, "block")),
    ("shards (512, 4096) tp2 bf16", 1024, 2048, BF16, 16, True,
     (True, "block")),
    ("shards (512, 4096) tp4 bf16", 2048, 1024, BF16, 16, True,
     (True, "warp")),
    ("shards (3, 72) tp2 bf16", 6, 36, BF16, 16, True, (False, "warp")),
    ("shards (3, 72) tp2 fp32", 6, 36, FP32, 16, True, (True, "warp")),
    ("shards (3, 72) tp4 fp32", 12, 18, FP32, 16, True, (False, "warp")),
    ("shards (5, 72) tp2 bf16", 10, 36, BF16, 16, True, (False, "warp")),
    ("shards (5, 72) tp4 bf16", 20, 18, BF16, 16, True, (False, "warp")),
    ("shards (4, 4096) tp2 bf16, base + 1", 8, 2048, BF16, 16, False,
     (False, "warp")),
    ("rank sum R 4 d 2048", 4, 2048, INT8, 8, True, (True, "block")),
    ("rank sum R 512 d 2048", 512, 2048, INT8, 8, True, (True, "block")),
    ("rank sum R 3 d 256", 3, 256, INT8, 8, True, (True, "warp")),
    ("rank sum R 5 d 18", 5, 18, INT8, 8, True, (False, "warp")),
    ("quantize_int8 (2048, 4096) bf16", 2048, 4096, BF16, 16, True,
     (True, "block")),
    ("rms_norm (2048, 4096) bf16", 2048, 4096, BF16, 16, True,
     (True, "block")),
    ("one row just under two segments", 1, 2 * native.SPLIT_MIN - 8, BF16,
     16, True, (True, "block")),
]

# (label, rows, d, element bytes, vector bytes, aligned, vec) of rows that
# split
LONG = [
    ("gradient rows dp=2 bf16", 2, GRAD_ROW, BF16, 16, True, True),
    ("gradient rows dp=2 fp32", 2, GRAD_ROW, FP32, 16, True, True),
    ("rank sum of the gradient rows", 1, GRAD_ROW, INT8, 8, True, True),
    ("chip_smoke shards tp4", 4, 4_194_600, BF16, 16, True, True),
    ("chip_smoke shards tp2", 2, 8_389_200, FP32, 16, True, True),
    ("odd width", 2, 2 ** 24 + 1, BF16, 16, True, False),
    ("unaligned base", 2, 2 ** 24, BF16, 16, False, False),
    ("odd-width rank sum", 1, 2 ** 22 + 3, INT8, 8, True, False),
    ("smallest split", 1, 2 * native.SPLIT_MIN, BF16, 16, True, True),
    ("263 rows of 40,000", 263, 40_000, BF16, 16, True, True),
]


@pytest.mark.parametrize("label,rows,d,elem,vec_bytes,aligned,want",
                         SERVING, ids=[c[0] for c in SERVING])
def test_row_plan_serving_rows_keep_their_launch(label, rows, d, elem,
                                                 vec_bytes, aligned, want):
    plan = native.row_plan(rows, d, elem, aligned, vec_bytes)
    assert (plan.vec, plan.mode) == want
    assert (plan.segments, plan.seg_len) == (1, d)
    # the rule RMSNorm's row_launch keeps
    vec, block = native._row_mode(d, elem, aligned, vec_bytes)
    assert (vec, "block" if block else "warp") == want


@pytest.mark.parametrize("label,rows,d,elem,vec_bytes,aligned,vec", LONG,
                         ids=[c[0] for c in LONG])
def test_row_plan_splits_long_rows(label, rows, d, elem, vec_bytes, aligned,
                                   vec):
    plan = native.row_plan(rows, d, elem, aligned, vec_bytes)
    assert plan.mode == "split" and plan.vec == vec
    assert plan.segments >= 2
    assert plan.seg_len >= native.SPLIT_MIN
    # whole vectors (one element on the scalar path)
    assert plan.seg_len % (vec_bytes // elem if vec else 1) == 0
    # the segments cover [0, d) once: every one non-empty, the last ragged
    bounds = [(k * plan.seg_len, min((k + 1) * plan.seg_len, d))
              for k in range(plan.segments)]
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    assert 0 < bounds[-1][1] - bounds[-1][0] <= plan.seg_len
    # enough blocks for the card, or as many as SPLIT_MIN allows
    blocks = rows * plan.segments
    assert blocks >= min(native.SPLIT_BLOCKS, rows * (d // native.SPLIT_MIN))
    if label.startswith("gradient"):
        assert blocks >= native.CARD_SMS
        assert d % plan.seg_len != 0        # a ragged last segment


@pytest.mark.parametrize("rows,d,what", [
    (1, 2 ** 31, "row width"),
    (2 ** 31, 8, "row count"),
    (2, 2 ** 32 + 16, "row width"),
])
def test_row_plan_refuses_32_bit_overflow(rows, d, what):
    with pytest.raises(ValueError, match=f"quantize_int8_shards: {what}"):
        native.row_plan(rows, d, BF16, True, kernel="quantize_int8_shards")
    native.row_plan(min(rows, native.INT_MAX), min(d, native.INT_MAX), BF16,
                    True)
