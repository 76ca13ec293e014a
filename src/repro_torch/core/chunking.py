"""Sequence-split policies (copy of ``repro/core/chunking.py``).

All splits are static Python ints.  Policies: ``even`` (the paper's
default), ``asymmetric``, ``adaptive`` and ``auto``, which picks the split
that minimises the simulated ISO pipeline time under ``perf/model.py`` on a
hardware profile (default ``"h100"``).  Multi-chunk splits generalise any
policy to num_chunks > 2.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

from repro_torch.config import ISOConfig, ModelConfig
from repro_torch.perf.model import DEFAULT_HW, simulate_iso_fractions


def _round_to(x: int, m: int) -> int:
    return max(m, int(round(x / m)) * m)


def _normalize(lengths: Sequence[int], seq_len: int, align: int) -> Tuple[int, ...]:
    out = [max(align, _round_to(l, align)) for l in lengths[:-1]]
    used = sum(out)
    if used >= seq_len:                      # degenerate: fall back to even
        n = len(lengths)
        base = seq_len // n
        if base >= align:                    # keep alignment when possible
            base = (base // align) * align
        out = [base] * (n - 1)
        used = base * (n - 1)
    return tuple(out) + (seq_len - used,)


def even_split(seq_len: int, n: int, align: int = 128) -> Tuple[int, ...]:
    return _normalize([seq_len / n] * n, seq_len, align)


def fraction_split(seq_len: int, fractions: Sequence[float], align: int = 128
                   ) -> Tuple[int, ...]:
    return _normalize([f * seq_len for f in fractions], seq_len, align)


def adaptive_split(seq_len: int, n: int, cfg: ModelConfig, align: int = 128
                   ) -> Tuple[int, ...]:
    """Equalise per-chunk cost  c(a,b) = alpha*(b^2-a^2)/2 + beta*(b-a)  where the
    quadratic term is attention over the prefix and the linear term is the dense
    (QKV/O + MLP) compute per token."""
    d, hq = cfg.d_model, cfg.num_heads
    hd = cfg.resolved_head_dim
    alpha = 4.0 * hq * hd
    ff = cfg.d_ff or (cfg.moe.d_ff_expert * cfg.moe.top_k if cfg.moe else d * 4)
    beta = 2.0 * d * (hq * hd * 2 + cfg.num_kv_heads * hd * 2) + 6.0 * d * ff
    total = alpha * seq_len ** 2 / 2 + beta * seq_len
    per = total / n
    bounds = [0]
    for _ in range(n - 1):
        a = bounds[-1]
        A, B, C = alpha / 2, beta, -(per + alpha * a * a / 2 + beta * a)
        b = (-B + math.sqrt(B * B - 4 * A * C)) / (2 * A)
        bounds.append(min(b, seq_len))
    lengths = [bounds[i + 1] - bounds[i] for i in range(n - 1)] + [seq_len - bounds[-1]]
    return _normalize(lengths, seq_len, align)


@functools.lru_cache(maxsize=1024)
def auto_split(seq_len: int, n: int, cfg: ModelConfig,
               hw_name: str = DEFAULT_HW, tp: int = 1, align: int = 128
               ) -> Tuple[int, ...]:
    """Search fractions minimising the simulated ISO pipeline time.  The
    first candidate of least time wins: at tp=1 the pipeline has no
    communication and every candidate costs the same in exact arithmetic,
    so floating-point rounding decides, as in the reference.  Cached: one
    search simulates every layer of the model for each of nine candidates
    (0.1-0.6 s for the dense configs on a CPU), and the engine asks at every
    admission and eager prefill call, where the reference's jit asks once
    per shape."""
    best, best_t = even_split(seq_len, n, align), float("inf")
    if n != 2:
        cands = [even_split(seq_len, n, align), adaptive_split(seq_len, n, cfg, align)]
    else:
        cands = [fraction_split(seq_len, (f, 1 - f), align)
                 for f in (0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7)]
        cands.append(adaptive_split(seq_len, 2, cfg, align))
    for c in cands:
        t = simulate_iso_fractions(cfg, c, hw_name=hw_name, tp=tp)
        if t < best_t:
            best, best_t = c, t
    return best


def grant_buckets(max_tokens: int, min_bucket: int = 16,
                  explicit: Sequence[int] = ()) -> Tuple[int, ...]:
    """Grant-size buckets: powers of two from ``min_bucket``, the top bucket
    capped at ``max_tokens``; ``explicit`` overrides the ladder and must still
    cover ``max_tokens``.  The engine pads every prefill grant up to its
    bucket, as the reference does, so the ISO chunk split of a grant (and
    hence its numerics) matches the reference call for call."""
    if explicit:
        out = tuple(sorted(set(int(b) for b in explicit)))
        assert out[0] >= 1 and out[-1] >= max_tokens, \
            f"explicit buckets {out} do not cover max_tokens={max_tokens}"
        return out
    b, out = max(1, min_bucket), []
    while b < max_tokens:
        out.append(b)
        b *= 2
    out.append(min(b, max_tokens))
    return tuple(out)


def round_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending; asserts coverage)."""
    for b in buckets:
        if n <= b:
            return b
    raise AssertionError(f"grant of {n} tokens exceeds largest bucket "
                         f"{buckets[-1]}")


def split_chunks(seq_len: int, iso: ISOConfig, cfg: ModelConfig, *,
                 align: int = 0, tp: int = 1, hw_name: str = DEFAULT_HW
                 ) -> Tuple[int, ...]:
    """Main entry: chunk lengths for a prefill of ``seq_len`` tokens.

    ``tp`` and ``hw_name`` reach only the ``auto`` policy: the tensor-
    parallel degree and the ``perf/model.HW_PROFILES`` entry it simulates.
    The reference defaults to tp=16 on its TPU profile; the port to tp=1 on
    ``"h100"``, and the engine passes its own tp to both its scheduler and
    its decoder, so under ``auto`` they cut the same chunks."""
    if (not iso.enabled or iso.num_chunks <= 1
            or seq_len < iso.min_chunk_tokens * iso.num_chunks):
        return (seq_len,)
    align = align or iso.chunk_align
    n = iso.num_chunks
    if iso.split_fractions:
        return fraction_split(seq_len, iso.split_fractions, align)
    if iso.split_policy == "even":
        return even_split(seq_len, n, align)
    if iso.split_policy == "asymmetric":
        fr = [0.6, 0.4] if n == 2 else [1.0 / n] * n
        return fraction_split(seq_len, fr, align)
    if iso.split_policy == "adaptive":
        return adaptive_split(seq_len, n, cfg, align)
    if iso.split_policy == "auto":
        return auto_split(seq_len, n, cfg, hw_name=hw_name, tp=tp, align=align)
    raise ValueError(f"unknown split policy {iso.split_policy!r}")
