"""Random weights for an afmoe decoder (Arcee Trinity), made on the device
from the seed in the tree the port's ``models.api`` takes, and handed alike
to the port and to the plain reference (``reference_afmoe.py``).

The distributions (the configuration file's ``assumed``): normal x 0.02
for the embedding, the head, every in-projection (wq, wk, wv, the gate wg,
w_up, w_gate of the dense, routed and shared FFNs) and the router; the out
projections (wo, every w_down) x 0.02 / sqrt(2 L); the expert bias normal
x 0.02; norms and the q/k norm scales at one.  The router and the expert
bias are float32, the rest the serving dtype.  Three ``normal_`` calls fill
three flat buffers (the 0.02 leaves, the out projections, the float32
leaves); every leaf is a view of one of them.

The routed experts of a layer are not drawn independently: each of their
matrices is ``sqrt(1 - a^2) C + a Z_e`` at its leaf's scale, C one
normal draw a layer and leaf (after the three buffers, layer by layer),
Z_e the expert's own draw, a = ``EXPERT_SPREAD``; each expert keeps its
leaf's variance and shares 1 - a^2 of it with the layer's others.  With
independent experts a routing flip between two near-tied experts, which
bf16's rounding makes at every few layers of a token, replaces a slot's
output outright; the flips compound over the 30 MoE layers until the
served tokens lie as far from the float32 reference's as an fp8 model's
do, and no limit on the check's widest gap tells bf16 from fp8 apart.

The tree: ``{"embed": {"table", "head"} (vocab_rows, D), "final_norm":
{"scale"}, "periods": ([layer 0], [layer 1], ...)}`` (an afmoe pattern
names one kind a layer, so each position holds one layer), a layer
``{"norm1", "post_attn_norm", "norm2", "post_mlp_norm": {"scale"},
"attn": {"wq" (D, Hq, hd), "wk", "wv" (D, Hkv, hd), "wo" (Hq, hd, D),
"wg" (D, Hq, hd), "q_norm", "k_norm" (hd,)}}`` and either ``"mlp":
{"w_up", "w_gate" (D, F), "w_down" (F, D)}`` (the first
``num_dense_layers``) or ``"moe": {"router" (D, E), "expert_bias" (E,),
"w_up", "w_gate" (E, D, Fe), "w_down" (E, Fe, D), "shared": {"w_up",
"w_gate" (D, Fs), "w_down" (Fs, D)}}``.  ``vocab_rows`` (>= vocab) is the
row count the program's embedding expects; rows past the vocabulary are
drawn like the rest and never sampled.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

STD = 0.02
EXPERT_SPREAD = 0.5     # a: an expert's own share of its matrices' spread


def numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def layer_shapes(cfg: Dict, i: int) -> Tuple[List, List, List]:
    """Layer i's (0.02, out-projection, float32) leaves: (path, shape)."""
    d, hq, hkv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    inner = [(("attn", "wq"), (d, hq, hd)), (("attn", "wk"), (d, hkv, hd)),
             (("attn", "wv"), (d, hkv, hd)), (("attn", "wg"), (d, hq, hd))]
    outer = [(("attn", "wo"), (hq, hd, d))]
    fp32: List = []
    if i < cfg["num_dense_layers"]:
        ff = cfg["intermediate_size"]
        inner += [(("mlp", "w_up"), (d, ff)), (("mlp", "w_gate"), (d, ff))]
        outer += [(("mlp", "w_down"), (ff, d))]
    else:
        e, fe = cfg["num_experts"], cfg["moe_intermediate_size"]
        fs = fe * cfg["num_shared_experts"]
        inner += [(("moe", "w_up"), (e, d, fe)),
                  (("moe", "w_gate"), (e, d, fe)),
                  (("moe", "shared", "w_up"), (d, fs)),
                  (("moe", "shared", "w_gate"), (d, fs))]
        outer += [(("moe", "w_down"), (e, fe, d)),
                  (("moe", "shared", "w_down"), (fs, d))]
        fp32 = [(("moe", "router"), (d, e)), (("moe", "expert_bias"), (e,))]
    return inner, outer, fp32


def spread(moe: Dict, gen: torch.Generator, out_std: float) -> None:
    """A layer's routed experts, drawn independently, moved in place around
    one common draw a leaf: W_e = sqrt(1 - a^2) C + a W_e, C normal at the
    leaf's scale (``out_std`` for w_down; module doc)."""
    a = EXPERT_SPREAD
    for name, std in (("w_up", STD), ("w_gate", STD), ("w_down", out_std)):
        w = moe[name]
        c = torch.empty(w.shape[1:], dtype=w.dtype, device=w.device)
        c.normal_(0.0, std, generator=gen)
        w.mul_(a).add_(c[None], alpha=(1.0 - a * a) ** 0.5)


def make(cfg: Dict, seed: int, device, vocab_rows: int,
         dtype=torch.bfloat16) -> Dict:
    d, hd, L = cfg["hidden_size"], cfg["head_dim"], cfg["num_hidden_layers"]
    if vocab_rows < cfg["vocab_size"]:
        raise ValueError(f"vocab_rows {vocab_rows} < vocab "
                         f"{cfg['vocab_size']}")
    shapes = [layer_shapes(cfg, i) for i in range(L)]
    n = [2 * vocab_rows * d, 0, 0]
    for groups in shapes:
        for j, group in enumerate(groups):
            n[j] += sum(numel(sh) for _, sh in group)
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    bufs = []
    for j, (count, dt, std) in enumerate((
            (n[0], dtype, STD), (n[1], dtype, STD / (2 * L) ** 0.5),
            (n[2], torch.float32, STD))):
        b = torch.empty(count, dtype=dt, device=device)
        b.normal_(0.0, std, generator=gen)
        bufs.append(b)
    cursor = [0, 0, 0]

    def take(j, shape):
        off = cursor[j]
        cursor[j] = off + numel(shape)
        return bufs[j][off:cursor[j]].view(shape)

    def ones(size):
        return torch.ones(size, dtype=torch.float32, device=device)

    embed = {"table": take(0, (vocab_rows, d)),
             "head": take(0, (vocab_rows, d))}
    periods = []
    for groups in shapes:
        layer = {k: {"scale": ones(d)} for k in
                 ("norm1", "post_attn_norm", "norm2", "post_mlp_norm")}
        layer["attn"] = {"q_norm": ones(hd), "k_norm": ones(hd)}
        for j, group in enumerate(groups):
            for path, shape in group:
                node = layer
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = take(j, shape)
        if "moe" in layer:
            spread(layer["moe"], gen, STD / (2 * L) ** 0.5)
        periods.append([layer])
    return {"embed": embed, "final_norm": {"scale": ones(d)},
            "periods": tuple(periods)}
