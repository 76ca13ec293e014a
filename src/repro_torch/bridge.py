"""Parameter bridge: the reference's ``api.init_params`` pytree, given as numpy
arrays, to the port's parameters, and back.

The reference stacks every layer leaf over pattern periods, ``(P, ...)``,
for ``lax.scan``; the port keeps one dict per layer, so ``from_reference``
unstacks ``params["periods"][i]`` into a list of P layer dicts.  The padded
head-slot layout of ``layers/heads.expand_heads`` is kept as it is.  bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects, so they are bit-cast through int16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t if device is None else t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``to_torch``; bf16 comes back as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def from_reference(ref: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params on ``device``."""
    out = {k: _map(ref[k], lambda a: to_torch(a, device))
           for k in ref if k != "periods"}
    periods = []
    for pos in ref["periods"]:
        n = np.asarray(_first_leaf(pos)).shape[0]
        periods.append([_map(pos, lambda a, p=p: to_torch(np.asarray(a)[p],
                                                          device))
                        for p in range(n)])
    out["periods"] = tuple(periods)
    return out


def to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's pytree layout with numpy leaves
    (layer dicts restacked over periods)."""
    out = {k: _map(params[k], to_numpy) for k in params if k != "periods"}

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        return np.stack([to_numpy(t) for t in layers])

    out["periods"] = tuple(stack(pos) for pos in params["periods"])
    return out
