"""Parameter bridge: the reference's ``api.init_params`` pytree, given as numpy
arrays, to the port's parameters, and back.

The reference stacks every layer leaf over pattern periods, ``(P, ...)``,
for ``lax.scan``; the port keeps one dict per layer, so ``from_reference``
unstacks ``params["periods"][i]`` into a list of P layer dicts.  The padded
head-slot layout of ``layers/heads.expand_heads`` is kept as it is.  bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects, so they are bit-cast through int16.  Whisper's ``{"encoder",
"decoder"}`` tree converts half by half (the encoder has no ``embed``;
LayerNorms carry a ``bias``; decoder layers ``cross`` and
``norm_cross``).  ``shard_params`` cuts params built at tp=N (whisper's
too) into one rank's local view, and ``save_npz``/``load_npz``
carry a reference-layout pytree between processes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import decoder


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


ENCDEC_KEYS = ("encoder", "decoder")


def _is_encdec(tree) -> bool:
    return set(tree) == set(ENCDEC_KEYS)


def from_reference(ref: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Reference params (numpy leaves) -> port params on ``device``.  An
    encoder-decoder tree (``{"encoder", "decoder"}``, whisper) converts
    each half."""
    if _is_encdec(ref):
        return {k: from_reference(ref[k], device) for k in ENCDEC_KEYS}
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


def shard_params(params: Dict[str, Any], rank: int, tp: int,
                 device=None) -> Dict[str, Any]:
    """Rank ``rank``'s local view of params built at tp=``tp``: the
    reference's ``init_params(key, cfg, tp=tp)`` as numpy (its layout, with
    period-stacked leaves; bridged to torch on the CPU first) or the port's
    ``api.init_params(seed, cfg, tp=tp)``.  Follows the reference's
    ``decoder_param_specs`` for the dense leaves (models/decoder.SHARD_AXIS);
    an encoder-decoder tree (whisper) is cut half by half, the decoder's
    cross-attention as its self-attention.  ``device`` given: the local
    view is moved there."""
    if _is_encdec(params):
        return {k: shard_params(params[k], rank, tp, device)
                for k in ENCDEC_KEYS}
    if isinstance(params["periods"][0], dict):          # reference layout
        params = from_reference(params)
    local = decoder.shard_params(params, rank, tp)
    if device is None:
        return local
    move = lambda tree: _map(tree, lambda t: t.to(device))
    out = {k: move(v) for k, v in local.items() if k != "periods"}
    out["periods"] = tuple([move(layer) for layer in pos]
                           for pos in local["periods"])
    return out


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_npz(path, ref: Dict[str, Any]) -> None:
    """Write a reference-layout pytree of numpy leaves (dicts and the
    ``periods`` tuples, an encoder-decoder's two halves included) to
    ``path``; bf16 leaves are stored bit-cast as int16 under a ``bf16:``
    key prefix."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(ref, "", flat)
    arrays = {}
    for k, a in flat.items():
        if a.dtype.name == "bfloat16":
            arrays["bf16:" + k] = a.view(np.int16)
        else:
            arrays[k] = a
    np.savez(path, **arrays)


def load_npz(path) -> Dict[str, Any]:
    """Inverse of ``save_npz``: the pytree with ``periods`` as a tuple and
    bf16 leaves as ``ml_dtypes.bfloat16``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            if key.startswith("bf16:"):
                import ml_dtypes
                key, a = key[5:], a.view(ml_dtypes.bfloat16)
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = a
    for half in (tree[k] for k in ENCDEC_KEYS) if _is_encdec(tree) \
            else (tree,):
        periods = half["periods"]
        half["periods"] = tuple(periods[str(i)]
                                for i in range(len(periods)))
    return tree


def to_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the reference's pytree layout with numpy leaves
    (layer dicts restacked over periods; each half of an encoder-decoder
    tree)."""
    if _is_encdec(params):
        return {k: to_reference(params[k]) for k in ENCDEC_KEYS}
    out = {k: _map(params[k], to_numpy) for k in params if k != "periods"}

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        return np.stack([to_numpy(t) for t in layers])

    out["periods"] = tuple(stack(pos) for pos in params["periods"])
    return out
