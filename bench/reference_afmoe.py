"""The plain reference of an afmoe decoder (Arcee Trinity) in float32
PyTorch, written from the published description.  For a layer with input
h (the configuration file's ``assumed`` states the same):

    x  = RMSNorm_in(h)
    q  = x Wq -> (Hq, hd);  k = x Wk, v = x Wv -> (Hkv, hd)
    q, k = RMSNorm_q(q), RMSNorm_k(k)         per head, over hd
    sliding layer: q, k = RoPE(q, k; rope_theta, rotate-half, all hd dims)
    full layer:    no rotary embedding (NoPE)
    a  = softmax(q k^T / sqrt(hd) + mask) v   causal; sliding: key position
                                              > query position - window
    o  = (a * sigmoid(x Wg)) Wo               Wg: D -> Hq hd
    h  = h + RMSNorm_post_attn(o)
    y  = RMSNorm_pre_mlp(h)
    m  = SwiGLU(y)  (the first num_dense_layers)  |  MoE(y)
    h  = h + RMSNorm_post_mlp(m)

    MoE(y): s = sigmoid(y Wr) (E scores); idx = topk(s + b, k), b the
            expert bias (selection only); w = s[idx] / (sum + 1e-20) when
            route_norm, times route_scale;
            MoE(y) = sum_j w_j E_idx_j(y) + E_shared(y),
            E(y) = (silu(y Wgate) * (y Wup)) Wdown

and the model: h0 = Embed(ids) x sqrt(D) (mup_enabled), a final RMSNorm,
the untied head.  Group query head h reads kv head h // (Hq / Hkv).  The
layer kinds come from the file's ``layer_types`` and
``num_dense_layers``.  The modelling code (transformers'
``models/afmoe/modeling_afmoe.py``) is not installed here, so these
equations are unchecked against it.

No kernel, cache or batching: each sequence runs whole, attention in
blocks of queries; every assignment is computed (no capacity), each token
from its own routing, the tokens of one sequence that chose an expert
taken through it together.  It imports nothing of the program under test
and reads only what the benchmark made: the configuration file and the
weight tree of ``weights_afmoe.make``.  Matmuls run in float32 with TF32
off.  Layer by layer, each layer's weights are cast to float32 only while
it runs, for every sequence at once.

``precision="fp8"`` is the control: every matmul's operands (weights per
output column, activations per row), the router's included, rounded to
float8 e4m3 with a scale to its range, the step below the bf16 the
configuration serves in.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

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
        self.d = int(cfg["hidden_size"])
        self.hq = int(cfg["num_attention_heads"])
        self.hkv = int(cfg["num_key_value_heads"])
        self.hd = int(cfg["head_dim"])
        self.vocab = int(cfg["vocab_size"])
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.window = int(cfg["sliding_window"])
        self.full = [t == "full_attention" for t in cfg["layer_types"]]
        self.dense = int(cfg["num_dense_layers"])
        self.top_k = int(cfg["num_experts_per_tok"])
        self.route_norm = bool(cfg["route_norm"])
        self.route_scale = float(cfg["route_scale"])
        self.embed_scale = self.d ** 0.5 if cfg.get("mup_enabled") else 1.0
        self.w = weights
        self.fp8 = precision == "fp8"
        self.qb = query_block

    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (..., K, N) weight in float32, rounded per output column under
        the control."""
        w = w.float()
        return _fp8(w, -2) if self.fp8 else w

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

    def _attention(self, q, k, v, window: int):
        """Causal attention of one sequence, over the last ``window``
        positions when it is not 0: q (S, Hq, hd), k/v (S, Hkv, hd) ->
        (S, Hq, hd)."""
        S, hq, hd = q.shape
        group = hq // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = torch.empty((S, hq, hd), dtype=torch.float32, device=q.device)
        keys = torch.arange(S, device=q.device)
        for a in range(0, S, self.qb):
            b = min(S, a + self.qb)
            lo = max(0, a - window + 1) if window else 0
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) * hd ** -0.5
            qpos = torch.arange(a, b, device=q.device)[:, None]
            kpos = keys[None, lo:b]
            mask = kpos > qpos
            if window:
                mask |= kpos <= qpos - window
            s = s.masked_fill(mask[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                    v[lo:b])
        return out

    def _swiglu(self, y, wg, wu, wd):
        return self._mm(torch.nn.functional.silu(self._mm(y, wg))
                        * self._mm(y, wu), wd)

    def _moe_weights(self, m: Dict) -> Dict:
        """A MoE layer's weights in float32 (rounded under the control),
        once for every sequence."""
        return {"router": self._weight(m["router"]),
                "bias": m["expert_bias"].float(),
                "experts": tuple(self._weight(m[n]) for n in
                                 ("w_gate", "w_up", "w_down")),
                "shared": tuple(self._weight(m["shared"][n]) for n in
                                ("w_gate", "w_up", "w_down"))}

    def _moe(self, m: Dict, y: torch.Tensor) -> torch.Tensor:
        """The dropless MoE of one sequence's rows y (S, D), ``m`` of
        ``_moe_weights``."""
        scores = torch.sigmoid(self._mm(y, m["router"]))
        idx = torch.topk(scores + m["bias"][None], self.top_k,
                         dim=-1).indices                        # (S, k)
        w = scores.gather(1, idx)
        if self.route_norm:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * self.route_scale
        wg, wu, wd = m["experts"]
        out = torch.zeros_like(y)
        for e in torch.unique(idx).tolist():
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            out.index_add_(0, rows, w[rows, slot][:, None]
                           * self._swiglu(y[rows], wg[e], wu[e], wd[e]))
        return out + self._swiglu(y, *m["shared"])

    def _layer(self, i: int, lw: Dict, xs: List[torch.Tensor]) -> None:
        d, hq, hkv, hd = self.d, self.hq, self.hkv, self.hd
        a = lw["attn"]
        wq = self._weight(a["wq"].reshape(d, hq * hd))
        wk = self._weight(a["wk"].reshape(d, hkv * hd))
        wv = self._weight(a["wv"].reshape(d, hkv * hd))
        wgate = self._weight(a["wg"].reshape(d, hq * hd))
        wo = self._weight(a["wo"].reshape(hq * hd, d))
        full = self.full[i]
        if i < self.dense:
            mlp = tuple(self._weight(lw["mlp"][k]) for k in
                        ("w_gate", "w_up", "w_down"))
        else:
            moe = self._moe_weights(lw["moe"])
        for n, h in enumerate(xs):
            S = h.shape[0]
            pos = torch.arange(S, device=h.device)
            x = self._rms(h, lw["norm1"]["scale"])
            q = self._rms(self._mm(x, wq).reshape(S, hq, hd), a["q_norm"])
            k = self._rms(self._mm(x, wk).reshape(S, hkv, hd), a["k_norm"])
            v = self._mm(x, wv).reshape(S, hkv, hd)
            if not full:
                q, k = self._rope(q, pos), self._rope(k, pos)
            att = self._attention(q, k, v, 0 if full else self.window)
            o = self._mm(att.reshape(S, hq * hd)
                         * torch.sigmoid(self._mm(x, wgate)), wo)
            h = h + self._rms(o, lw["post_attn_norm"]["scale"])
            y = self._rms(h, lw["norm2"]["scale"])
            m = self._swiglu(y, *mlp) if i < self.dense \
                else self._moe(moe, y)
            xs[n] = h + self._rms(m, lw["post_mlp_norm"]["scale"])

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (S,) integer, the float32 logits over
        the vocabulary (len(rows_i), vocab) at its positions ``rows_i``."""
        with exact_fp32():
            table = self.w["embed"]["table"]
            xs = [table[t.long()].float() * self.embed_scale for t in seqs]
            for i, pos in enumerate(self.w["periods"]):
                (lw,) = pos
                self._layer(i, lw, xs)
            head = self._weight(self.w["embed"]["head"][:self.vocab].t())
            out = []
            for x, r in zip(xs, rows):
                h = self._rms(x[r.long()], self.w["final_norm"]["scale"])
                out.append(self._mm(h, head))
            return out
