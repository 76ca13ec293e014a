"""Host-side token sampling from full-vocab logits (greedy / temperature /
top-k); a copy of ``repro/serving/sampler.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.serving.requests import SamplingParams


def sample(logits: np.ndarray, sp: SamplingParams, step: int) -> int:
    """logits: (V,) fp32 for one request."""
    lf = np.asarray(logits, np.float32)
    if sp.temperature <= 0.0:
        return int(np.argmax(lf))
    lf = lf / sp.temperature
    if sp.top_k:
        kth = np.partition(lf, -sp.top_k)[-sp.top_k]
        lf = np.where(lf < kth, -np.inf, lf)
    lf = lf - lf.max()
    p = np.exp(lf)
    p /= p.sum()
    rng = np.random.default_rng(sp.seed * 1_000_003 + step)
    return int(rng.choice(len(p), p=p))
