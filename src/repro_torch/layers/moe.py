"""Expert-parallel Mixture-of-Experts, local-shard view (port of
``repro/layers/moe.py``).

Experts are split over the TP ranks (each holds ``e_loc`` of the
``padded_experts(tp)``); activations arrive replicated, so dispatch needs no
all-to-all: every rank serves the token -> expert assignments that land on
its own experts and returns an unreduced partial, which rides the same TP
all-reduce as the dense MLP's (the collective the ISO scheduler hides).

Capacity-based (GShard-style) routing with index scatter and gather, as the
reference: positions come from an exclusive cumulative count over the
flattened (T·k) assignments, token-major and slot-minor; assignments at or
past the capacity ``C`` go to a dump slot that is sliced away.  ``C`` is
taken from the call's own token count, so the output depends on how the
caller batches tokens (ISO chunk, bucket-padded grant, pack, decode batch,
verify window) whenever capacity drops an assignment: that is the
reference's semantics, not a fault.

Everything here has static shapes and reads nothing back to the host (no
``.item()``, ``nonzero`` or boolean-mask indexing), so it runs inside the
serving engine's CUDA graphs.  The expert products are plain
``torch.matmul`` (the reference's are ``jnp.einsum`` outside any Pallas
kernel).

``torch.topk`` does not promise ``lax.top_k``'s order among equal values
(the lower index first).  With ``top_k`` at most the number of real experts
(the padding experts sit at probability 0), only exact fp32 ties between
real experts' probabilities could pick or order experts differently.

A ``SigmoidMoEConfig`` (afmoe; not in the reference) routes and dispatches
otherwise: ``route_sigmoid`` (fp32 sigmoid scores, the top k of scores plus
the ``expert_bias`` leaf, weights from the scores alone) and
``moe_dropless``, which computes every assignment through the grouped
expert kernels of ``kernels/moe_experts.py`` (the plain per-expert path on
the CPU): no capacity, so a token's output does not depend on the batch it
rode in.  Its host ranges ``moe/route``, ``moe/experts`` and
``moe/combine`` mark the eager path under a recording profiler
(``obs.torchprof.annotate``); a caller's ``hits`` buffer (0-d int64)
accumulates, on the device, the local experts each call reached.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig, SigmoidMoEConfig
from repro_torch.layers.mlp import matmul
from repro_torch.obs import torchprof

EXPERT_BIAS_STD = 0.02


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig, tp: int,
             num_layers: int, dtype, device) -> dict:
    """Random MoE weights with the reference's distributions: the router
    ``(D, E_pad)`` in fp32 whatever ``dtype``, expert-stacked ``w_up`` /
    ``w_gate`` ``(E_pad, D, F)`` and ``w_down`` ``(E_pad, F, D)``, and the
    shared expert's 2-D leaves when the config has one.  Expert tensors
    are drawn expert by expert, so no fp32 transient of a whole stack
    (kimi's would be 22.5 GB) is ever made."""
    e_pad = mcfg.padded_experts(tp)
    s, so = 0.02, 0.02 / (2 * num_layers) ** 0.5
    f = mcfg.d_ff_expert

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * std).to(dtype)

    def stacked(shape, std):
        out = torch.empty((e_pad,) + shape, dtype=dtype, device=device)
        for e in range(e_pad):
            out[e] = normal(shape, std)
        return out

    p = {"router": torch.randn((d_model, e_pad), generator=gen,
                               dtype=torch.float32, device=device) * s,
         "w_up": stacked((d_model, f), s),
         "w_gate": stacked((d_model, f), s),
         "w_down": stacked((f, d_model), so)}
    if mcfg.shared_expert_d_ff:
        fs = mcfg.shared_expert_d_ff
        p["shared"] = {"w_up": normal((d_model, fs), s),
                       "w_gate": normal((d_model, fs), s),
                       "w_down": normal((fs, d_model), so)}
    if isinstance(mcfg, SigmoidMoEConfig):
        # fp32, replicated: the sigmoid router's selection bias
        p["expert_bias"] = torch.randn((e_pad,), generator=gen,
                                       dtype=torch.float32,
                                       device=device) * EXPERT_BIAS_STD
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, mcfg: MoEConfig,
          e_pad: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in fp32.  x: (T, D) -> weights (T, k), expert ids
    (T, k) int64, and the Switch load-balance aux loss (a 0-d tensor).
    Padding experts (ids >= ``num_experts``) are masked to -inf before the
    softmax; the k weights are renormalised by max(sum, 1e-9)."""
    experts = torch.arange(e_pad, device=x.device)
    logits = x.float() @ router_w.float()                  # (T, E_pad)
    logits = torch.where((experts < mcfg.num_experts)[None], logits,
                         torch.full_like(logits, float("-inf")))
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    # aux (Switch): E * sum_e(fraction of tokens whose top-1 is e x mean
    # p_e); one-hots here are comparisons, since F.one_hot checks its values
    # on the host
    frac = (idx[:, :1] == experts).float().mean(dim=0)
    aux = mcfg.num_experts * torch.sum(frac * probs.mean(dim=0))
    return w, idx, aux


def route_sigmoid(router_w: torch.Tensor, bias: torch.Tensor,
                  x: torch.Tensor, mcfg: MoEConfig, e_pad: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """afmoe routing in fp32.  x: (T, D) -> weights (T, k) fp32 and expert
    ids (T, k) int64: s = sigmoid(x router); the top k of s + bias, the
    padding experts masked to -inf; the weights are s there (the bias only
    chooses), divided by their sum + 1e-20 when ``route_norm``, times
    ``route_scale``."""
    experts = torch.arange(e_pad, device=x.device)
    scores = torch.sigmoid(x.float() @ router_w.float())       # (T, E_pad)
    choose = torch.where((experts < mcfg.num_experts)[None],
                         scores + bias.float()[None],
                         torch.full_like(scores, float("-inf")))
    idx = torch.topk(choose, mcfg.top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if mcfg.route_norm:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * mcfg.route_scale, idx


def local_experts(idx: torch.Tensor, expert_offset: int,
                  e_loc: int) -> torch.Tensor:
    """Global expert ids -> this rank's local ids, ``e_loc`` for an expert
    another rank holds."""
    local = idx - expert_offset
    return torch.where((local >= 0) & (local < e_loc), local,
                       torch.full_like(local, e_loc))


def moe_dropless(p: dict, x: torch.Tensor, mcfg: MoEConfig, *, tp: int,
                 expert_offset: int, decode: bool = False,
                 hits: torch.Tensor = None) -> torch.Tensor:
    """The sigmoid router's layer, dropless: x (B, S, D), replicated across
    the TP ranks -> this rank's unreduced partial (B, S, D): its experts'
    weighted outputs (fp32, slot order) plus its shard of the shared
    expert, in x's dtype.  ``decode`` picks the decode call's kernels;
    ``hits`` (0-d int64) gains the local experts this call reached."""
    from repro_torch.kernels.moe_experts import moe_experts
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    e_pad = p["router"].shape[1]
    e_loc = e_pad // tp
    with torchprof.annotate("moe/route"):
        w, idx = route_sigmoid(p["router"], p["expert_bias"], xt, mcfg,
                               e_pad)
        local = local_experts(idx, expert_offset, e_loc)
    with torchprof.annotate("moe/experts"):
        y, counts = moe_experts(xt, local, w, p["w_gate"], p["w_up"],
                                p["w_down"], decode=decode)
        if hits is not None:
            hits.add_((counts[:e_loc] > 0).sum())
    with torchprof.annotate("moe/combine"):
        y = y.reshape(B, S, D)
        if "shared" in p:
            sh = p["shared"]
            u = matmul(x, sh["w_up"])
            g = matmul(x, sh["w_gate"])
            y = y + matmul(F.silu(g.float()).to(x.dtype) * u,
                           sh["w_down"]).float()
        return y.to(x.dtype)


def capacity(tokens: int, mcfg: MoEConfig, e_pad: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens."""
    return max(4, int(math.ceil(tokens * mcfg.top_k / e_pad
                                * mcfg.capacity_factor)))


def moe_partial(p: dict, x: torch.Tensor, mcfg: MoEConfig, *, tp: int,
                expert_offset: int, decode: bool = False,
                hits: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D), replicated across the TP ranks.  Returns (the unreduced
    partial output (B, S, D), the aux loss / tp).  ``expert_offset``: the
    first global expert id this rank owns.  A ``SigmoidMoEConfig``'s layer is
    ``moe_dropless`` (``decode``, ``hits``), its aux 0."""
    if isinstance(mcfg, SigmoidMoEConfig):
        return (moe_dropless(p, x, mcfg, tp=tp, expert_offset=expert_offset,
                             decode=decode, hits=hits),
                torch.zeros((), device=x.device))
    B, S, D = x.shape
    T, k = B * S, mcfg.top_k
    xt = x.reshape(T, D)
    e_pad = p["router"].shape[1]
    e_loc = e_pad // tp
    w, idx, aux = route(p["router"], xt, mcfg, e_pad)
    C = capacity(T, mcfg, e_pad)

    # positions: exclusive count of earlier assignments (token-major, slot-
    # minor) to the same LOCAL expert; other ranks' experts go to dump row
    # e_loc, and every assignment past the capacity to dump column C.  The
    # one-hot is laid out expert-major, (e_loc+1, T*k), so the count runs
    # along the contiguous dimension: down the outer dimension of a
    # (T*k, e_loc+1) one-hot, PyTorch's scan takes one thread a column
    local = idx.reshape(-1) - expert_offset                      # (T*k,)
    is_local = (local >= 0) & (local < e_loc)
    local_c = torch.where(is_local, local, torch.full_like(local, e_loc))
    onehot = (torch.arange(e_loc + 1, device=x.device)[:, None]
              == local_c[None]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot).gather(
        0, local_c[None])[0].long()
    pos = pos.reshape(T, k)
    local_e = local_c.reshape(T, k)
    in_cap = (pos < C) & is_local.reshape(T, k)
    pos_c = torch.where(in_cap, pos, torch.full_like(pos, C))

    # dispatch: scatter the tokens into (e_loc+1, C+1, D), a slot at a time;
    # the dump row and column take every dropped write and are sliced away
    dtype = x.dtype
    buf = torch.zeros((e_loc + 1, C + 1, D), dtype=dtype, device=x.device)
    for j in range(k):
        buf.index_put_((local_e[:, j], pos_c[:, j]), xt)
    buf = buf[:e_loc, :C]                                 # (e_loc, C, D)

    # expert SwiGLU, batched over the local experts: silu in fp32, cast to
    # the activation dtype before the product with up (the dense MLP's)
    up = matmul(buf, p["w_up"])
    gate = matmul(buf, p["w_gate"])
    h = F.silu(gate.float()).to(dtype) * up
    out_buf = F.pad(matmul(h, p["w_down"]), (0, 0, 0, 1, 0, 1))  # dump reads 0

    # combine: gather and weight, accumulating in the activation dtype in
    # slot order j = 0..k-1
    y = torch.zeros((T, D), dtype=dtype, device=x.device)
    for j in range(k):
        g = out_buf[local_e[:, j], pos_c[:, j]]                  # (T, D)
        y = y + g * (w[:, j] * in_cap[:, j]).to(dtype)[:, None]
    y = y.reshape(B, S, D)

    # the shared (dense) expert: column -> row parallel like the dense MLP,
    # so its partial rides the same all-reduce; added last
    if "shared" in p:
        sh = p["shared"]
        u = matmul(x, sh["w_up"])
        g = matmul(x, sh["w_gate"])
        y = y + matmul(F.silu(g.float()).to(dtype) * u, sh["w_down"])
    return y, aux / tp
