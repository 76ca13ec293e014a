"""Dropless grouped expert products of an MoE layer: CUDA kernels, plain
version, wrapper.

Replaces no TPU kernel (the reference's expert products are ``jnp.einsum``
over a capacity buffer); added for the sigmoid-routed, dropless MoE of the
afmoe block (``layers/moe.moe_dropless``), whose per-expert row counts are
ragged.  The kernels are in ``csrc/moe_experts.cu``.

For x (T, D), each token's k slots' LOCAL expert ids ``local`` (T, k)
(``e_loc`` for an expert another rank holds) and combine weights ``w`` (T,
k) fp32, with the rank's expert stacks ``w_gate``/``w_up`` (e_loc, D, F)
and ``w_down`` (e_loc, F, D):

    y[t] = sum_j w[t, j] * E_{local[t, j]}(x[t])       (fp32, slot order)
    E_e(x) = (silu(x Wg_e) * (x Wu_e)) Wd_e

where a slot of another rank's expert adds nothing.  Returns ``(y, counts)``,
``counts`` (e_loc + 1,) int32 the assignments per local expert (the last
entry those of other ranks).

On the card the wrapper sorts the T k assignments by expert on the device
(``torch.sort``, stable), counts and offsets them, and launches two kernels
(gate/up with SiLU into bf16 rows in sorted order; down, each row's output
times its weight in fp32 at its assignment's row), then sums each token's k
rows in slot order.  Nothing is read back to the host, so a CUDA graph
captures the call.  ``decode`` picks the small-row kernels
(``moe_experts_decode_*``, 16 rows a tile) over the grant ones
(``moe_experts_grant_*``, 64).  The kernels take bf16 only, with D a
multiple of 128 and F of 64; other CUDA inputs raise.

``moe_experts_plain`` computes the same function expert by expert over
every token (a slot's output selected where it routes to that expert): no
sort and no host read.  The wrapper uses it only for CPU tensors; it is the
CPU path and the oracle of the card's check.  It rounds ``x Wg`` and ``x
Wu`` to the activation type before the SiLU product, where the kernel
keeps them in fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import native
from repro_torch.layers.mlp import matmul

_SOURCE = "moe_experts.cu"


def expert_counts(local: torch.Tensor, e_loc: int) -> torch.Tensor:
    """(e_loc + 1,) int32: the assignments of ``local`` (T, k) per local
    expert, the last entry those of other ranks' experts."""
    flat = local.reshape(-1)
    return torch.zeros(e_loc + 1, dtype=torch.int32,
                       device=local.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def moe_experts_plain(x, local, w, w_gate, w_up, w_down
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels (module doc)."""
    T, D = x.shape
    k = local.shape[1]
    e_loc = w_gate.shape[0]
    slots = torch.zeros((T, k, D), dtype=torch.float32, device=x.device)
    for e in range(e_loc):
        u = matmul(x, w_up[e])
        g = matmul(x, w_gate[e])
        h = (F.silu(g.float()) * u.float()).to(x.dtype)
        out = matmul(h, w_down[e]).float()                   # (T, D)
        slots = torch.where((local == e)[..., None], out[:, None], slots)
    y = slots[:, 0] * w[:, :1]
    for j in range(1, k):
        y = y + slots[:, j] * w[:, j:j + 1]
    return y, expert_counts(local, e_loc)


def _check(x, local, w, w_gate, w_up, w_down) -> None:
    T, D = x.shape
    e_loc, _, Fw = w_gate.shape
    if local.shape != w.shape or local.shape[0] != T:
        raise ValueError(f"moe_experts: local {tuple(local.shape)} and w "
                         f"{tuple(w.shape)} must both be (T={T}, k)")
    if w_up.shape != w_gate.shape or tuple(w_down.shape) != (e_loc, Fw, D) \
            or w_gate.shape[1] != D:
        raise ValueError(f"moe_experts: expert stacks {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do not "
                         f"fit x (T, {D})")
    for name, t in (("local", local), ("w", w), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down)):
        if t.device != x.device:
            raise ValueError(f"moe_experts: {name} on {t.device}, x on "
                             f"{x.device}")
    if local.dtype != torch.int64 or w.dtype != torch.float32:
        raise TypeError(f"moe_experts: local must be int64 and w float32, "
                        f"got {local.dtype} and {w.dtype}")


def moe_experts(x: torch.Tensor, local: torch.Tensor, w: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, *, decode: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module doc.  CPU tensors take the plain version; CUDA
    tensors launch the kernels."""
    _check(x, local, w, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_experts_plain(x, local, w, w_gate, w_up, w_down)
    T, D = x.shape
    k = local.shape[1]
    e_loc, _, Fw = w_gate.shape
    if not (x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype
            == torch.bfloat16):
        raise TypeError(f"moe_experts: the kernels take bfloat16 x and "
                        f"experts, got {x.dtype} and {w_gate.dtype}")
    if D % 128 or Fw % 64:
        raise ValueError(f"moe_experts: D={D} must be a multiple of 128 and "
                         f"F={Fw} of 64")
    A = T * k
    if A > native.INT_MAX // max(D, Fw):
        raise ValueError(f"moe_experts: {A} assignments x width {max(D, Fw)}"
                         f" overflow the kernels' 32-bit row index")
    x = x.contiguous()
    w_gate, w_up, w_down = (t.contiguous() for t in (w_gate, w_up, w_down))
    flat = local.reshape(-1)
    order = torch.sort(flat, stable=True).indices.to(torch.int32)
    counts = expert_counts(local, e_loc)
    offsets = torch.zeros(e_loc + 1, dtype=torch.int32, device=x.device)
    offsets[1:] = torch.cumsum(counts[:e_loc], 0, dtype=torch.int32)
    h = torch.empty((A, Fw), dtype=torch.bfloat16, device=x.device)
    # a slot of another rank's expert: its row, which no kernel writes
    y = torch.zeros((A, D), dtype=torch.float32, device=x.device)
    lib = native.library(_SOURCE)
    stream = native.stream_of(x)
    dec = int(decode)
    err = lib.moe_gate_up(dec, x.data_ptr(), order.data_ptr(),
                          offsets.data_ptr(), w_gate.data_ptr(),
                          w_up.data_ptr(), h.data_ptr(), A, D, Fw, k, e_loc,
                          stream)
    native.check_launch("moe_gate_up", err)
    wts = w.reshape(-1).contiguous()
    err = lib.moe_down(dec, h.data_ptr(), order.data_ptr(),
                       offsets.data_ptr(), wts.data_ptr(), w_down.data_ptr(),
                       y.data_ptr(), A, D, Fw, e_loc, stream)
    native.check_launch("moe_down", err)
    native.LAUNCHES["moe_experts"] += 1
    native.VARIANTS["moe_experts/decode" if decode
                    else "moe_experts/grant"] += 1
    y = y.view(T, k, D)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out, counts
