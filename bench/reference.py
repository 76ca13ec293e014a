"""The plain reference: a dense decoder in float32 PyTorch, written from
the published description (Qwen2 / Qwen3): RMSNorm before attention and
before the MLP, q/k/v projections, per-head RMSNorm of q and k before the
rotary embedding where the configuration has ``qk_norm`` (Qwen3), rotary
embedding on rotated halves, causal attention with GQA (q head h reads kv
head h // (Hq / Hkv)), the output projection, a SwiGLU MLP, a final
RMSNorm and an untied LM head over the vocabulary.  No kernel, cache or
batching: each sequence runs whole, attention in blocks of queries.

It imports nothing of the program under test and reads only what the
benchmark made: the configuration file and the weight tree of
``weights.make``.  Matmuls run in float32 with TF32 off.  Layer by layer,
each layer's weights are cast to float32 only while it runs, for every
sequence at once, so a run's bf16 weights and the sequences' float32
activations are all it holds.

``precision="fp8"`` is the control: every matmul's operands (weights per
output column, activations per row) rounded to float8 e4m3 with a scale to
its range, the step below the bf16 the configuration serves in.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

from counts import Sizes

FP8_MAX = 448.0              # largest finite float8 e4m3fn value


@contextlib.contextmanager
def exact_fp32():
    """float32 matmuls without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    def __init__(self, cfg: Dict, weights: Dict, precision: str = "fp32",
                 query_block: int = 512):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.s = Sizes(cfg)
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.qk_norm = bool(cfg.get("qk_norm"))
        self.w = weights
        self.fp8 = precision == "fp8"
        self.qb = query_block

    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (K, N) weight in float32, rounded per output column under the
        control."""
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (S, K) @ w (K, N) of ``_weight``, in float32."""
        return (_fp8(x, -1) if self.fp8 else x) @ w

    def _rms(self, x, scale):
        return x * torch.reciprocal(torch.sqrt(
            x.pow(2).mean(-1, keepdim=True) + self.eps)) * scale.float()

    def _rope(self, x, pos):
        half = x.shape[-1] // 2
        inv = 1.0 / self.theta ** (torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * inv[None]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, q, k, v):
        """Causal attention of one sequence: q (S, Hq, hd), k/v (S, Hkv,
        hd) -> (S, Hq * hd)."""
        S, hq, hd = q.shape
        group = hq // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = torch.empty((S, hq, hd), dtype=torch.float32, device=q.device)
        keys = torch.arange(S, device=q.device)
        for a in range(0, S, self.qb):
            b = min(S, a + self.qb)
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * hd ** -0.5
            mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
            s = s.masked_fill(mask[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:b])
        return out.reshape(S, hq * hd)

    def _layer(self, lw: Dict, xs: List[torch.Tensor]) -> None:
        s = self.s
        d, hq, hkv, hd = s.d, s.hq, s.hkv, s.hd
        a = lw["attn"]
        wq = self._weight(a["wq"].reshape(d, hq * hd))
        wk = self._weight(a["wk"].reshape(d, hkv * hd))
        wv = self._weight(a["wv"].reshape(d, hkv * hd))
        wo = self._weight(a["wo"].reshape(hq * hd, d))
        m = lw["mlp"]
        wg, wu, wd = (self._weight(m[k]) for k in ("w_gate", "w_up", "w_down"))
        for i, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=x.device)
            h = self._rms(x, lw["norm1"]["scale"])
            q = self._mm(h, wq).reshape(S, hq, hd)
            k = self._mm(h, wk).reshape(S, hkv, hd)
            v = self._mm(h, wv).reshape(S, hkv, hd)
            if self.qk_norm:
                q = self._rms(q, a["q_norm"])
                k = self._rms(k, a["k_norm"])
            q, k = self._rope(q, pos), self._rope(k, pos)
            x = x + self._mm(self._attention(q, k, v), wo)
            h = self._rms(x, lw["norm2"]["scale"])
            x = x + self._mm(torch.nn.functional.silu(self._mm(h, wg))
                             * self._mm(h, wu), wd)
            xs[i] = x

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (S,) integer, the float32 logits over
        the vocabulary (len(rows_i), vocab) at its positions ``rows_i``."""
        V = self.s.vocab
        with exact_fp32():
            table = self.w["embed"]["table"]
            xs = [table[t.long()].float() for t in seqs]
            for lw in self.w["periods"][0]:
                self._layer(lw, xs)
            head = self._weight(self.w["embed"]["head"][:V].t())
            out = []
            for x, r in zip(xs, rows):
                h = self._rms(x[r.long()], self.w["final_norm"]["scale"])
                out.append(self._mm(h, head))
            return out
