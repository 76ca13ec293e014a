"""One rank's prefill and decode calls: the distributed boundary shared by
the dense ``Engine`` and the dry run (port of ``repro/launch/runner.py``).

The reference wraps ``api.prefill`` / ``api.decode_step`` in
``jit(shard_map(...))`` over a device mesh.  The port runs one process per
rank, so the same boundary is a plain callable that runs THIS rank's shard
through the same ``api`` calls, with the rank's ``AxisCtx`` from its
``launch.mesh.TPGroup`` (``None``: one device, identity collectives).  There
is nothing to trace or compile: the callables run eagerly, and a decode
updates the caches in place where the reference donates them.

The batch follows the reference's rule (``_b_axes``): when the global batch
splits evenly over the data ranks (``pods x data``), each rank runs its own
rows of it, else every rank runs the whole batch (long_500k's B=1).  The
logits stay vocab-sharded, as the reference's ``P(b, None, "model")``
out_spec: ``gather_logits`` concatenates the ranks' shards into the full
row (``core/overlap.all_gather_last``), the port's ``device_get``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.core.overlap import AxisCtx, all_gather_last
from repro_torch.launch.mesh import TPGroup
from repro_torch.models import api


def _b_axes(config: Config, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Batch mesh axes, or None when the batch can't shard (long_500k: B=1)."""
    p = config.parallel
    dp = p.pods * p.data
    if global_batch % dp or global_batch < dp:
        return None
    return ("pod", "data") if p.pods > 1 else ("data",)


def rank_ctx(config: Config, group: Optional[TPGroup]) -> AxisCtx:
    """This rank's collectives (``training.trainer.make_axis_ctx``, which
    holds ``config.parallel`` to the group); without a group, one device
    and identity collectives, whatever ``config.parallel`` says (the
    reference's ``Engine(mesh=None)``)."""
    if group is None:
        return AxisCtx()
    from repro_torch.training.trainer import make_axis_ctx
    return make_axis_ctx(config, group)


def _rows(ctx: AxisCtx, b_axes, n: int) -> slice:
    """This data rank's rows of a global batch of ``n``."""
    if b_axes is None or ctx.dp == 1:
        return slice(0, n)
    per = n // ctx.dp
    return slice(ctx.dp_rank * per, (ctx.dp_rank + 1) * per)


def make_prefill_fn(config: Config, group: Optional[TPGroup] = None, *,
                    logits_mode: str = "last", return_cache: bool = False,
                    cache_len: int = 0, global_batch: int) -> Callable[..., Dict[str, Any]]:
    """``fn(params, batch) -> {"logits_local", "moe_aux"[, "caches"]}``:
    ``params`` this rank's shard, ``batch`` the global batch (``api.prefill``
    keys), of which the rank runs its rows (``_b_axes``).  ``logits_local``
    is the rank's vocab shard (None under ``logits_mode="none"``)."""
    cfg, iso = config.model, config.iso
    ctx = rank_ctx(config, group)
    rows = _rows(ctx, _b_axes(config, global_batch), global_batch)

    def fn(params, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        local = {k: v[rows] for k, v in batch.items()}
        out = api.prefill(params, cfg, ctx, iso, local,
                          logits_mode=logits_mode, return_cache=return_cache,
                          cache_len=cache_len)
        res = {"logits_local": out.get("logits_local"),
               "moe_aux": out["moe_aux"]}
        if return_cache:
            res["caches"] = out["caches"]
        return res

    fn.ctx = ctx
    return fn


def make_decode_fn(config: Config, group: Optional[TPGroup] = None, *,
                   global_batch: int
                   ) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """``fn(params, tokens, caches, lengths) -> (logits_local, caches)``:
    one decode step of this rank over its local caches (its rows and kv
    heads, ``api.init_caches(..., local=True)``), updated in place, on the
    sequential schedule, as the reference's; tokens and lengths are the
    global batch's, of which the rank runs its rows."""
    cfg = config.model
    ctx = rank_ctx(config, group)
    rows = _rows(ctx, _b_axes(config, global_batch), global_batch)

    def fn(params, tokens, caches, lengths):
        return api.decode_step(params, cfg, ctx, tokens[rows], caches,
                               lengths[rows])

    fn.ctx = ctx
    return fn


def gather_logits(logits_local: torch.Tensor, ctx: AxisCtx) -> torch.Tensor:
    """(B, S, V_loc) vocab-sharded logits -> the full (B, S, V) rows, the
    same on every rank."""
    return all_gather_last(logits_local, ctx)
