"""Vocab-sharded embedding + LM head, local-shard view (port of
``repro/layers/embeddings.py``)."""
from __future__ import annotations

import torch


def embed_partial(p: dict, tokens: torch.Tensor, vocab_offset: int = 0
                  ) -> torch.Tensor:
    """tokens: (B,S) integer; the table is the LOCAL vocab shard.  Tokens
    outside this shard's range contribute zero (the caller reduces over the
    model axis; identity at tp=1)."""
    table = p["table"]
    v_loc = table.shape[0]
    local = tokens.long() - vocab_offset
    ok = (local >= 0) & (local < v_loc)
    e = table[torch.clamp(local, 0, v_loc - 1)]
    return e * ok[..., None].to(e.dtype)


def lm_head_local(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> LOCAL logits (B,S,V_loc)."""
    w = p.get("head", p["table"])
    return torch.matmul(x, w.t())
