"""Mamba-style selective SSM, local-shard view (port of
``repro/layers/ssm.py``).

  * The scan ``h_t = decay_t * h_{t-1} + drive_t`` runs as a parallel prefix
    over the sequence with the reference's combine ``(al*ar, bl*ar + br)``
    in fp32: a doubling (Hillis-Steele) scan of log2(S) tensor steps, where
    the reference calls ``jax.lax.associative_scan``.  The two trees add in
    different orders, so the results agree to rounding, not bit for bit.
  * dt / B / C are projected from the replicated d_model input, not from
    the sharded inner activation, so the block needs no mid-layer
    collective: its one all-reduce is after the row-parallel ``w_out``,
    the reduce ISO overlaps.
  * The depthwise conv carries its last (width-1) inputs, so chunked
    prefill (ISO chunks, resumed grants) is exact across chunk boundaries
    given the carried state.

Everything has static shapes and reads nothing back to the host, so it runs
inside the serving engine's CUDA graphs.  State handoff =
``SSMState(conv (B, conv_dim-1, inner_loc), h (B, inner_loc, N) fp32)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig, pad_to_multiple
from repro_torch.layers.mlp import matmul


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv_dim-1, inner_loc), the model dtype
    h: torch.Tensor       # (B, inner_loc, N) fp32


def inner_dim(d_model: int, scfg: SSMConfig, tp: int) -> int:
    return pad_to_multiple(scfg.expand * d_model, tp)


def init_ssm(gen: torch.Generator, d_model: int, scfg: SSMConfig, tp: int,
             num_layers: int, dtype, device) -> dict:
    """Random SSM weights with the reference's distributions: normal x 0.02
    projections (``w_out`` x 0.02/sqrt(2L)) in ``dtype``; ``dt_bias`` 0,
    ``a_log`` 0 (A = -1) and ``d_skip`` 1 in fp32.  x and z keep SEPARATE
    input projections: a fused (D, 2*inner) matrix would interleave wrongly
    when its column dim shards over TP."""
    inner = inner_dim(d_model, scfg, tp)
    n = scfg.state_dim
    s, so = 0.02, 0.02 / (2 * num_layers) ** 0.5

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * std).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_x": normal((d_model, inner), s),
        "w_z": normal((d_model, inner), s),
        "conv_w": normal((scfg.conv_dim, inner), s),
        "w_dt": normal((d_model, inner), s),
        "dt_bias": torch.zeros((inner,), **f32),
        "w_b": normal((d_model, n), s),
        "w_c": normal((d_model, n), s),
        "a_log": torch.zeros((inner, n), **f32),
        "d_skip": torch.ones((inner,), **f32),
        "w_out": normal((inner, d_model), so),
    }


def init_ssm_state(batch: int, inner_loc: int, scfg: SSMConfig, dtype,
                   device=None) -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, scfg.conv_dim - 1, inner_loc), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, inner_loc, scfg.state_dim),
                      dtype=torch.float32, device=device))


def _causal_conv(x, conv_state, w):
    """Depthwise causal conv with carried state.  x: (B, S, inner); the
    taps add in the reference's order, in x's dtype."""
    width = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)    # (B, S+w-1, inner)
    out = xp[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, S:] if width > 1 else conv_state
    return out, new_state


def prefix_scan(decay: torch.Tensor, drive: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over dim 1 of the pairs (decay, drive) under the
    combine ``(al, bl) . (ar, br) = (al*ar, bl*ar + br)`` (l the earlier):
    returns (the decays' running product, h of every step from h0 = 0).
    Each doubling step combines element t with element t - d."""
    S = decay.shape[1]
    d = 1
    while d < S:
        drive = torch.cat([drive[:, :d],
                           drive[:, :-d] * decay[:, d:] + drive[:, d:]], 1)
        decay = torch.cat([decay[:, :d], decay[:, :-d] * decay[:, d:]], 1)
        d *= 2
    return decay, drive


def ssm_partial(p: dict, x: torch.Tensor, scfg: SSMConfig,
                state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, S, D) replicated -> (unreduced partial (B, S, D), new state).
    Exact across chunk boundaries given the carried state (the ISO
    invariant)."""
    B, S, _ = x.shape
    inner = p["w_x"].shape[1]
    n = p["a_log"].shape[1]
    if state is None:
        state = SSMState(
            conv=torch.zeros((B, p["conv_w"].shape[0] - 1, inner),
                             dtype=x.dtype, device=x.device),
            h=torch.zeros((B, inner, n), dtype=torch.float32,
                          device=x.device))
    x_in = matmul(x, p["w_x"])
    z = matmul(x, p["w_z"])
    x_c, conv_new = _causal_conv(x_in, state.conv, p["conv_w"])
    x_c = F.silu(x_c.float())
    dt = F.softplus(matmul(x, p["w_dt"]).float() + p["dt_bias"])
    b_proj = matmul(x, p["w_b"]).float()                  # (B, S, N)
    c_proj = matmul(x, p["w_c"]).float()
    a = -torch.exp(p["a_log"])                             # (inner, N)
    decay = torch.exp(dt[..., None] * a)                   # (B, S, inner, N)
    drive = (dt * x_c)[..., None] * b_proj[:, :, None, :]
    prod, hscan = prefix_scan(decay, drive)
    h = hscan + prod * state.h[:, None]                    # carry h0 in
    y = torch.matmul(h, c_proj[..., None])[..., 0] + x_c * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = matmul(y, p["w_out"])
    return out, SSMState(conv=conv_new.to(state.conv.dtype), h=h[:, -1])


def ssm_decode_partial(p: dict, x: torch.Tensor, scfg: SSMConfig,
                       state: SSMState):
    """One recurrent step (O(1) in the sequence length)."""
    return ssm_partial(p, x, scfg, state)
