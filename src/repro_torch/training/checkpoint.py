"""Checkpoints in the reference's layout (port of
``repro/training/checkpoint.py``), with numpy and no other package.

``<dir>/manifest.json`` holds the step and each leaf's shape and dtype;
``<dir>/shard_<k>.npz`` holds the leaves, keyed by the reference's
``keystr`` of its tree (a layer leaf stacked over periods, as the
reference stacks it).  bf16 leaves are stored as their int16 bits, with
``"bfloat16"`` as their dtype in the manifest (numpy has no bf16 of its
own), so a save restores bit for bit; an fp32 checkpoint written by the
reference restores too.  ``gather_params`` assembles the whole tp-built
model from the ranks' shards, the reference's global arrays."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.overlap import AxisCtx
from repro_torch.core.quantized_collectives import all_gather_stack
from repro_torch.models.decoder import shard_axis
from repro_torch.training.trainer import param_leaves


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" and a.dtype == np.int16:
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def save(path: str, tree: Dict[str, Any], step: int = 0,
         shard: int = 0) -> None:
    """Write ``tree`` (a dict over port params, e.g. ``{"params":
    params}``) as ``shard_<shard>.npz`` and the manifest."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {"step": step, "leaves": {}}
    for leaf in param_leaves(tree):
        parts = [_to_numpy(t) for t in leaf.tensors]
        dtype = parts[0][1]
        a = np.stack([p for p, _ in parts]) if leaf.ndim > \
            leaf.tensors[0].ndim else parts[0][0]
        arrays[leaf.name] = a
        meta["leaves"][leaf.name] = {"shape": list(a.shape), "dtype": dtype}
    np.savez(os.path.join(path, f"shard_{shard}.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def restore(path: str, tree_like: Dict[str, Any], shard: int = 0):
    """(tree, step): the checkpoint in the structure, dtypes and devices
    of ``tree_like``."""
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    new: Dict[int, torch.Tensor] = {}
    with np.load(os.path.join(path, f"shard_{shard}.npz")) as data:
        for leaf in param_leaves(tree_like):
            t = _to_torch(data[leaf.name],
                          meta["leaves"][leaf.name]["dtype"])
            stacked = leaf.ndim > leaf.tensors[0].ndim
            for i, like in enumerate(leaf.tensors):
                src = t[i] if stacked else t
                if tuple(src.shape) != tuple(like.shape):
                    raise ValueError(f"{leaf.name}: checkpoint shape "
                                     f"{tuple(src.shape)}, want "
                                     f"{tuple(like.shape)}")
                new[id(like)] = src.to(dtype=like.dtype, device=like.device)
    return _map(tree_like, lambda t: new[id(t)]), meta["step"]


def gather_params(params: Dict[str, Any], ctx: AxisCtx) -> Dict[str, Any]:
    """The whole tp-built model from every model rank's shard (run on all
    of them): each sharded leaf concatenated over the ranks along its
    axis; the identity at tp=1."""
    if ctx.tp_axis is None:
        return params

    def walk(node, parent: str):
        out = {}
        for k, v in node.items():
            if k == "periods":
                out[k] = tuple([walk(layer, "") for layer in pos]
                               for pos in v)
            elif isinstance(v, dict):
                out[k] = walk(v, k)
            else:
                axis = shard_axis(k, parent, v.ndim)
                out[k] = v if axis is None else torch.cat(
                    list(all_gather_stack(v, ctx.group, ctx.tp)), dim=axis)
        return out

    return walk(params, "")
