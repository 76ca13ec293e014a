"""Self-speculative decoding (copy of ``repro/serving/speculative.py``).

Draft model: a per-request bigram table ("last token -> most recent
successor") built online from the prompt and the generated stream, so no
extra weights.  Verify: one K-token decode step through the paged decode
kernel; greedy acceptance of the longest matching prefix yields 1..K tokens
a model call.  The paged engine commits only accepted tokens to the
allocator; the KV of rejected window positions stays in the pages past the
request's length, where nothing reads it (serving/kvcache.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class BigramDraft:
    def __init__(self):
        self.table: Dict[int, int] = {}
        self.last: int = -1

    def observe(self, tokens: Sequence[int]) -> None:
        prev = self.last
        for t in tokens:
            if prev >= 0:
                self.table[prev] = int(t)
            prev = int(t)
        self.last = prev

    def draft(self, k: int) -> List[int]:
        out, cur = [], self.last
        for _ in range(k):
            cur = self.table.get(cur, cur if cur >= 0 else 0)
            out.append(int(cur))
        return out


def accept_greedy(draft: List[int], argmaxes: np.ndarray) -> List[int]:
    """argmaxes[i] = the greedy prediction after position i of the [last,
    d1..d_{K-1}] verify window.  Returns the accepted new tokens (>= 1: at
    worst plain decode)."""
    out = []
    for i, d in enumerate(draft):
        model_tok = int(argmaxes[i])
        out.append(model_tok)
        if model_tok != d:
            break
    else:
        # every draft token accepted: bank the model's bonus prediction too
        out.append(int(argmaxes[len(draft)]))
    return out
