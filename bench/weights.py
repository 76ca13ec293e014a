"""Random weights for a dense decoder, made on the device from the seed in
the tree the port's ``models.api`` takes, and handed alike to the port and
to the plain reference.

The distributions are the reference package's: normal x 0.02, the out
projections (``wo``, ``w_down``) x 0.02 / sqrt(2 L), norms and the q/k
norm scales at one (float32).  Two ``normal_`` calls fill two flat
buffers in the serving dtype (the 0.02 leaves, then the out projections);
every leaf is a view of one of them.

The tree: ``{"embed": {"table", "head"} (vocab_rows, D), "final_norm":
{"scale"}, "periods": ([one dict a layer],)}``, a layer ``{"norm1":
{"scale"}, "attn": {"wq" (D, Hq, hd), "wk", "wv" (D, Hkv, hd), "wo" (Hq,
hd, D)[, "q_norm", "k_norm" (hd,)]}, "norm2": {"scale"}, "mlp": {"w_up",
"w_gate" (D, F), "w_down" (F, D)}}``.  ``vocab_rows`` (>= vocab) is the
row count the program's embedding expects; rows past the vocabulary are
drawn like the rest and never sampled.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from counts import Sizes


def make(cfg: Dict, seed: int, device, vocab_rows: int,
         dtype=torch.bfloat16) -> Dict:
    s = Sizes(cfg)
    d, hq, hkv, hd, ff, L = s.d, s.hq, s.hkv, s.hd, s.ff, s.layers
    if vocab_rows < s.vocab:
        raise ValueError(f"vocab_rows {vocab_rows} < vocab {s.vocab}")
    inner: List[Tuple[str, Tuple[int, ...]]] = [
        ("wq", (d, hq, hd)), ("wk", (d, hkv, hd)), ("wv", (d, hkv, hd)),
        ("w_up", (d, ff)), ("w_gate", (d, ff))]
    outer: List[Tuple[str, Tuple[int, ...]]] = [("wo", (hq, hd, d)),
                                                ("w_down", (ff, d))]

    def numel(shape):
        n = 1
        for x in shape:
            n *= x
        return n

    n_in = 2 * vocab_rows * d + L * sum(numel(sh) for _, sh in inner)
    n_out = L * sum(numel(sh) for _, sh in outer)
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    a = torch.empty(n_in, dtype=dtype, device=device)
    a.normal_(0.0, 0.02, generator=gen)
    b = torch.empty(n_out, dtype=dtype, device=device)
    b.normal_(0.0, 0.02 / (2 * L) ** 0.5, generator=gen)
    cursor = {"a": 0, "b": 0}

    def take(buf, key, shape):
        n = numel(shape)
        off = cursor[key]
        cursor[key] = off + n
        return buf[off:off + n].view(shape)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    embed = {"table": take(a, "a", (vocab_rows, d)),
             "head": take(a, "a", (vocab_rows, d))}
    layers = []
    for _ in range(L):
        w = {k: take(a, "a", sh) for k, sh in inner}
        w.update({k: take(b, "b", sh) for k, sh in outer})
        attn = {k: w[k] for k in ("wq", "wk", "wv", "wo")}
        if cfg.get("qk_norm"):
            attn["q_norm"] = ones(hd)
            attn["k_norm"] = ones(hd)
        layers.append({"norm1": {"scale": ones(d)}, "attn": attn,
                       "norm2": {"scale": ones(d)},
                       "mlp": {k: w[k] for k in ("w_up", "w_gate",
                                                 "w_down")}})
    return {"embed": embed, "final_norm": {"scale": ones(d)},
            "periods": (layers,)}
