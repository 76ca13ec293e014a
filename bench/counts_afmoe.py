"""The benchmark's operation and byte counts for an afmoe configuration
(Arcee Trinity), from its published sizes; ``counts.py`` counts a dense
decoder and does not apply (it reads one FFN width for every layer and
counts attention over every resident position).

They count the work a token needs, whatever implements it:

* Matmul parameters a token passes through, once each (2 operations a
  parameter): q, k, v, o and the output gate every layer; the dense SwiGLU
  (3 D F) on the first ``num_dense_layers``; on the others the router (D
  E), the k routed experts and the shared ones (3 D Fe each).
* Attention: a token at position p attends min(p + 1, window) positions
  on a sliding layer and p + 1 on a full one, 4 Hq hd operations a
  position (q.k and p.v).
* The LM head (2 D vocab) counts only at a sampled position.
* One MoE layer call over T tokens moves the weights of the experts its
  tokens reach, counted as the expectation under uniform routing, E (1 -
  (1 - k/E)^T) experts of 3 D Fe bf16 values each, plus its activations in
  and out (T D bf16 each); it computes T k 3 D Fe multiply-adds.
"""
from __future__ import annotations

from typing import Dict

from counts import BF16, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S  # noqa: F401

FULL = "full_attention"


class Sizes:
    """The sizes the counts need, read from an afmoe configuration file."""

    def __init__(self, cfg: Dict):
        self.layers = int(cfg["num_hidden_layers"])
        self.d = int(cfg["hidden_size"])
        self.hq = int(cfg["num_attention_heads"])
        self.hkv = int(cfg["num_key_value_heads"])
        self.hd = int(cfg["head_dim"])
        self.ff = int(cfg["intermediate_size"])
        self.vocab = int(cfg["vocab_size"])
        self.window = int(cfg["sliding_window"])
        self.full_layers = sum(1 for t in cfg["layer_types"] if t == FULL)
        self.dense_layers = int(cfg["num_dense_layers"])
        self.moe_layers = self.layers - self.dense_layers
        self.experts = int(cfg["num_experts"])
        self.top_k = int(cfg["num_experts_per_tok"])
        self.fe = int(cfg["moe_intermediate_size"])
        self.shared = int(cfg["num_shared_experts"])

    @property
    def expert_params(self) -> int:
        """One expert's matmul parameters (gate, up, down)."""
        return 3 * self.d * self.fe

    @property
    def matmul_params(self) -> int:
        """Parameters of the matrices a token passes through, per model."""
        d, hd = self.d, self.hd
        # q, o and the gate; k and v
        attn = 3 * d * self.hq * hd + 2 * d * self.hkv * hd
        moe = d * self.experts + (self.top_k + self.shared) * self.expert_params
        return (self.layers * attn + self.dense_layers * 3 * d * self.ff
                + self.moe_layers * moe)


def attended(s: Sizes, position: int) -> int:
    """Positions a token at ``position`` attends, summed over the layers."""
    p = position + 1
    return (s.full_layers * p
            + (s.layers - s.full_layers) * min(p, s.window))


def attention_flops(s: Sizes, positions: int) -> float:
    """Attention over ``positions`` attended (layer, position) pairs."""
    return 4.0 * s.hq * s.hd * positions


def prompt_flops(s: Sizes, prompt_len: int) -> float:
    """A whole prompt: every position through the matrices, causal
    attention (windowed on the sliding layers), the head at the last
    position."""
    n, w = prompt_len, s.window
    full = n * (n + 1) // 2
    m = min(n, w)
    sliding = m * (m + 1) // 2 + (n - m) * w
    pairs = s.full_layers * full + (s.layers - s.full_layers) * sliding
    return (2.0 * s.matmul_params * n + attention_flops(s, pairs)
            + 2.0 * s.d * s.vocab)


def decode_flops(s: Sizes, position: int) -> float:
    """One decoded token whose input sits at ``position``."""
    return (2.0 * s.matmul_params + attention_flops(s, attended(s, position))
            + 2.0 * s.d * s.vocab)


def experts_reached(s: Sizes, tokens: int) -> float:
    """Experts a call of ``tokens`` tokens reaches under uniform
    routing."""
    return s.experts * (1.0 - (1.0 - s.top_k / s.experts) ** tokens)


def moe_call_bytes(s: Sizes, tokens: int) -> float:
    """What one MoE layer call's routed experts must move: the weights of
    the experts reached, the activations in and out."""
    return (experts_reached(s, tokens) * s.expert_params * BF16
            + 2.0 * tokens * s.d * BF16)


def moe_call_flops(s: Sizes, tokens: int) -> float:
    """The routed experts' operations of one MoE layer call."""
    return 2.0 * tokens * s.top_k * s.expert_params


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
