"""xLSTM blocks (arXiv:2405.04517), local-shard view (port of
``repro/layers/xlstm.py``).

mLSTM: the matrix-memory LSTM in its chunkwise-parallel form (an intra-chunk
quadratic term plus the inter-chunk recurrent state C), the natural ISO
state-handoff point.  Under TP q/k and the scalar gates are replicated; the
v/output feature dim is column-sharded, C is sharded along its v axis and
the out-projection is row-parallel, so the block ends in the all-reduce ISO
overlaps.  A call of S tokens runs chunks of ``inner_chunk`` (256) tokens,
or ONE chunk of S when S is not a multiple of it (the reference's fallback:
a paged grant of 300 tokens is one 300 x 300 chunk).

sLSTM: the scalar-memory LSTM with recurrent block-diagonal (per head)
connections, strictly sequential: a Python loop over tokens where the
reference runs ``lax.scan``.  Its weights are replicated and its stage ends
in no collective (``reduces=False`` in models/blocks.py): the case where
ISO does not apply.

Both read nothing back to the host, so they run inside the serving
engine's CUDA graphs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.layers.mlp import matmul


class MLSTMState(NamedTuple):
    c: torch.Tensor       # (B, H, hd_k, hd_v_loc) fp32
    n: torch.Tensor       # (B, H, hd_k) fp32
    m: torch.Tensor       # (B, H) fp32 log-stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor       # (B, D) fp32
    h: torch.Tensor       # (B, D) fp32
    n: torch.Tensor       # (B, D) fp32
    m: torch.Tensor       # (B, D) fp32


def _normal(gen, shape, std, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> dict:
    """The reference's distributions: normal x 0.02 projections (D, H, hd)
    in ``dtype`` (``w_out`` (H, hd, D) x 0.02/sqrt(2L)); the gate weights
    ``w_i``/``w_f`` (D, H) in fp32, ``f_bias`` 3 (forget gates open) and
    ``i_bias`` 0 in fp32."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    s, so = 0.02, 0.02 / (2 * cfg.num_layers) ** 0.5
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_q": _normal(gen, (d, h, hd), s, dtype, device),
        "w_k": _normal(gen, (d, h, hd), s, dtype, device),
        "w_v": _normal(gen, (d, h, hd), s, dtype, device),
        "w_og": _normal(gen, (d, h, hd), s, dtype, device),
        "w_i": _normal(gen, (d, h), s, torch.float32, device),
        "w_f": _normal(gen, (d, h), s, torch.float32, device),
        "f_bias": torch.full((h,), 3.0, **f32),
        "i_bias": torch.zeros((h,), **f32),
        "w_out": _normal(gen, (h, hd, d), so, dtype, device),
    }


def init_mlstm_state(batch: int, heads: int, hd_k: int, hd_v_loc: int,
                     device=None) -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(c=torch.zeros((batch, heads, hd_k, hd_v_loc), **f32),
                      n=torch.zeros((batch, heads, hd_k), **f32),
                      m=torch.full((batch, heads), -1e30, **f32))


def _heads(x, w):
    """``bsd,dhk->bshk``."""
    B, S, _ = x.shape
    return matmul(x, w.reshape(w.shape[0], -1)).reshape(B, S, *w.shape[1:])


def _mlstm_chunk(q, k, v, ilog, flog, state: MLSTMState):
    """One chunk, parallel form.  q, k: (B, L, H, hdk) fp32; v: (B, L, H,
    hdv_loc) fp32; ilog/flog: (B, L, H).  Returns (h_out (B, L, H,
    hdv_loc), new state)."""
    L = q.shape[1]
    F_ = torch.cumsum(flog, dim=1)                          # cumulative log-f
    # stabilizers: intra source term i_s - F_s; inter term m0 (F = 0 at the
    # chunk start)
    run_max = torch.cummax(ilog - F_, dim=1).values
    m0 = state.m                                            # (B, H)
    m_t = torch.maximum(F_ + run_max, F_ + m0[:, None])     # (B, L, H)
    # intra-chunk: scores_ts = (q_t.k_s) exp(F_t - F_s + i_s - m_t), s <= t
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, L, .)
    logits = torch.matmul(qh, kh.transpose(-1, -2))         # (B, H, T, S)
    Fh = F_.transpose(1, 2)                                 # (B, H, L)
    ih = ilog.transpose(1, 2)
    mh = m_t.transpose(1, 2)
    dmat = Fh[:, :, :, None] - Fh[:, :, None, :] + ih[:, :, None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    w_intra = torch.where(mask, torch.exp(dmat - mh[:, :, :, None]),
                          torch.zeros((), device=q.device))
    h_intra = torch.matmul(w_intra * logits, vh).transpose(1, 2)
    # normalizer as xLSTM's: n_t = sum_s w_ts k_s; the denominator uses
    # |q . n_t|
    n_intra = torch.matmul(w_intra, kh).transpose(1, 2)    # (B, L, H, hdk)
    inter_w = torch.exp(Fh + m0[:, :, None] - mh)           # (B, H, L)
    h_inter = (torch.matmul(qh, state.c)
               * inter_w[..., None]).transpose(1, 2)        # (B, L, H, hdv)
    n_inter = state.n[:, None] * inter_w.transpose(1, 2)[..., None]
    num = h_intra + h_inter
    n_vec = n_intra + n_inter
    denom = torch.abs((q * n_vec).sum(-1))                  # (B, L, H)
    denom = torch.maximum(denom, torch.exp(-m_t))
    h_out = num / denom[..., None]
    # end-of-chunk state
    m_L = m_t[:, -1]                                        # (B, H)
    FL = F_[:, -1]
    carry = torch.exp(FL + m0 - m_L)                        # (B, H)
    wsrc = torch.exp(FL[:, None] - F_ + ilog - m_L[:, None])  # (B, L, H)
    kw = (kh * wsrc.transpose(1, 2)[..., None])             # (B, H, L, hdk)
    c_new = carry[:, :, None, None] * state.c + \
        torch.matmul(kw.transpose(-1, -2), vh)
    n_new = carry[:, :, None] * state.n + kw.sum(2)
    return h_out, MLSTMState(c=c_new, n=n_new, m=m_L)


def mlstm_partial(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MLSTMState] = None,
                  inner_chunk: int = 256) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, S, D) replicated -> (unreduced partial (B, S, D), new state).
    k is pre-scaled by hd^-0.5 at projection, so the carried C sees the same
    scaling as the intra-chunk logits."""
    B, S, _ = x.shape
    H = cfg.num_heads
    hdk = p["w_q"].shape[2]
    hdv = p["w_v"].shape[2]                     # local shard of the v dim
    if state is None:
        state = init_mlstm_state(B, H, hdk, hdv, device=x.device)
    q = _heads(x, p["w_q"]).float()
    k = _heads(x, p["w_k"]).float() * (hdk ** -0.5)
    v = _heads(x, p["w_v"]).float()
    og = torch.sigmoid(_heads(x, p["w_og"]).float())
    xf = x.float()
    ilog = xf @ p["w_i"] + p["i_bias"]
    flog = F.logsigmoid(xf @ p["w_f"] + p["f_bias"])
    L = min(inner_chunk, S)
    if S % L:
        L = S                      # one chunk for lengths off the grid
    hs = []
    for c0 in range(0, S, L):
        h, state = _mlstm_chunk(q[:, c0:c0 + L], k[:, c0:c0 + L],
                                v[:, c0:c0 + L], ilog[:, c0:c0 + L],
                                flog[:, c0:c0 + L], state)
        hs.append(h)
    h = (torch.cat(hs, 1) if len(hs) > 1 else hs[0]) * og
    w_out = p["w_out"]
    out = matmul(h.to(w_out.dtype).reshape(B, S, -1),
                 w_out.reshape(-1, w_out.shape[2]))
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> dict:
    """The reference's distributions: input gates ``w_{i,f,z,o}`` (D, D)
    in ``dtype``, recurrent ``r_{i,f,z,o}`` (H, hd, hd) and ``f_bias`` (3)
    in fp32, and the out-projection ``w_proj`` (D, D), named apart from
    ssm/mlstm's ``w_out`` because it is replicated, not row-split."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    s = 0.02
    p = {}
    for g in ("i", "f", "z", "o"):
        p[f"w_{g}"] = _normal(gen, (d, d), s, dtype, device)
    for g in ("i", "f", "z", "o"):
        p[f"r_{g}"] = _normal(gen, (h, hd, hd), s, torch.float32, device)
    p["f_bias"] = torch.full((d,), 3.0, dtype=torch.float32, device=device)
    p["w_proj"] = _normal(gen, (d, d), s / (2 * cfg.num_layers) ** 0.5,
                          dtype, device)
    return p


def init_slstm_state(batch: int, d: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, h=z.clone(), n=z + 1.0, m=z.clone())


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    """Strictly sequential.  x: (B, S, D) -> (the FULL output (B, S, D),
    state).  The weights are replicated over TP ranks: the caller must NOT
    reduce this block's output."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    if state is None:
        state = init_slstm_state(B, D, device=x.device)
    xf = x.float()
    pre = {g: xf @ p[f"w_{g}"].float() for g in ("i", "f", "z", "o")}
    pre["f"] = pre["f"] + p["f_bias"]
    # the four recurrent matrices side by side: one (H, hd, 4 hd) product a
    # step, each gate's columns the reference's per-gate einsum
    r = torch.cat([p[f"r_{g}"] for g in ("i", "f", "z", "o")], dim=2)
    c, h, n, m = state
    hs = []
    for t in range(S):
        rec = torch.matmul(h.reshape(B, H, hd).transpose(0, 1), r)
        rec = rec.reshape(H, B, 4, hd).permute(2, 1, 0, 3).reshape(4, B, D)
        i_t = pre["i"][:, t] + rec[0]
        f_t = pre["f"][:, t] + rec[1]
        z_t = torch.tanh(pre["z"][:, t] + rec[2])
        o_t = torch.sigmoid(pre["o"][:, t] + rec[3])
        lf = F.logsigmoid(f_t)
        m_new = torch.maximum(lf + m, i_t)
        i_e = torch.exp(i_t - m_new)
        f_e = torch.exp(lf + m - m_new)
        c = f_e * c + i_e * z_t
        n = torch.clamp(f_e * n + i_e, min=1e-6)
        h = o_t * c / n
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                  # (B, S, D)
    return matmul(y, p["w_proj"]), SLSTMState(c=c, h=h, n=n, m=m)
