"""The benchmark's own operation and byte counts, from a configuration's
published sizes, and the card's published peaks.

They count the work a token needs, whatever implements it: a later
program that pads, packs or recomputes does more work, not more of this.

* A token passes through every matrix of every layer once: 2 x the
  layers' matmul parameters (q, k, v, o, gate, up, down; the embedding
  lookup is no matmul and counts nothing).
* Attention: a token at position p attends p + 1 positions (itself and
  every earlier one), 4 x layers x Hq x hd operations a position (q.k and
  p.v, two operations a multiply-add each).
* The LM head (2 x d x vocab) counts only at a sampled position: the last
  prompt position and every decoded one.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BF16 = 2
FP32 = 4


class Sizes:
    """The sizes the counts need, read from a configuration file."""

    def __init__(self, cfg: Dict):
        self.layers = int(cfg["num_hidden_layers"])
        self.d = int(cfg["hidden_size"])
        self.hq = int(cfg["num_attention_heads"])
        self.hkv = int(cfg["num_key_value_heads"])
        self.hd = int(cfg.get("head_dim") or self.d // self.hq)
        self.ff = int(cfg["intermediate_size"])
        self.vocab = int(cfg["vocab_size"])

    @property
    def matmul_params(self) -> int:
        """Parameters of the matrices a token passes through, per model."""
        d, hd = self.d, self.hd
        attn = d * self.hq * hd * 2 + d * self.hkv * hd * 2
        return self.layers * (attn + 3 * d * self.ff)

    @property
    def kv_bytes_per_position(self) -> int:
        """bf16 K and V of one position, every layer."""
        return self.layers * 2 * self.hkv * self.hd * BF16


def attention_flops(s: Sizes, positions: int) -> float:
    """Attention over ``positions`` attended positions, every layer."""
    return 4.0 * s.layers * s.hq * s.hd * positions


def prompt_flops(s: Sizes, prompt_len: int) -> float:
    """A whole prompt: every position through the matrices, causal
    attention, and the LM head at the last position."""
    attended = prompt_len * (prompt_len + 1) // 2
    return (2.0 * s.matmul_params * prompt_len
            + attention_flops(s, attended) + 2.0 * s.d * s.vocab)


def decode_flops(s: Sizes, position: int) -> float:
    """One decoded token whose input sits at ``position``."""
    return (2.0 * s.matmul_params + attention_flops(s, position + 1)
            + 2.0 * s.d * s.vocab)


def paged_decode_bytes(s: Sizes, resident: int) -> float:
    """What one request's row of one decode step must move through the
    paged decode attention, every layer: each resident K and V byte read
    once (bf16), q read (bf16) and the output written (the fp32 partial
    and its two fp32 softmax statistics a head)."""
    q_out = s.hq * s.hd * BF16 + s.hq * (s.hd + 2) * FP32
    return resident * s.kv_bytes_per_position + s.layers * q_out


def paged_decode_flops(s: Sizes, resident: int) -> float:
    return attention_flops(s, resident)


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
