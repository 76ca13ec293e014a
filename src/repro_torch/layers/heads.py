"""GQA head layout under tensor parallelism (copy of ``repro/layers/heads.py``).

``head_layout`` is framework-free; ``expand_heads`` works on numpy arrays and
torch tensors (the reference's version uses ``jnp``).  See the reference's
module docstring for the slot construction; at tp=1 it is the unpadded layout
whenever ``Hq == kv * G``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class HeadLayout:
    hq: int                  # logical q heads
    hkv: int                 # logical kv heads
    hq_pad: int              # padded q slots (divisible by tp)
    hkv_eff: int             # kv slots incl. replication (divisible by tp)
    group_eff: int           # q slots per kv slot
    q_map: tuple             # slot -> logical q head or -1 (pad)
    kv_map: tuple            # slot -> logical kv head or -1 (pad)


def head_layout(hq: int, hkv: int, tp: int) -> HeadLayout:
    assert 1 <= hkv <= hq
    kv_eff = tp * math.ceil(hkv / tp)
    c = kv_eff // hkv                       # copies per logical kv head
    used_kv = hkv * c                       # <= kv_eff; rest are pad slots
    G = math.ceil(hq / hkv)
    g_eff = math.ceil(G / c)
    hq_pad = kv_eff * g_eff
    assert hq_pad % tp == 0 and kv_eff % tp == 0 and c * g_eff >= G

    kv_map = [-1] * kv_eff
    for t in range(used_kv):
        kv_map[t] = t // c
    q_map = [-1] * hq_pad
    for j in range(hkv):
        base = j * c * g_eff
        n_q = min(G, hq - j * G)            # last group may be short
        for w in range(n_q):
            q_map[base + w] = j * G + w
    # invariant: q slot s reads kv slot s // g_eff which must hold its logical kv head
    for s, h in enumerate(q_map):
        if h >= 0:
            assert kv_map[s // g_eff] == h // G, (s, h, hq, hkv, tp)
    return HeadLayout(hq, hkv, hq_pad, kv_eff, g_eff, tuple(q_map), tuple(kv_map))


def expand_heads(w, mapping, axis: int):
    """Gather logical head slices into padded slots; pad slots become zero.

    ``w`` (numpy array or torch tensor) has the logical head axis at
    ``axis``; returns the slot-expanded array of the same kind."""
    mapping = np.asarray(mapping)
    idx = np.where(mapping >= 0, mapping, 0)
    mask_shape = [1] * w.ndim
    mask_shape[axis] = len(mapping)
    keep = (mapping >= 0).reshape(mask_shape)
    if isinstance(w, torch.Tensor):
        out = torch.index_select(w, axis, torch.as_tensor(idx, device=w.device))
        return out * torch.as_tensor(keep, dtype=out.dtype, device=w.device)
    out = np.take(w, idx, axis=axis)
    return out * keep.astype(out.dtype)
