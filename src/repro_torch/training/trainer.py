"""The distributed train step (port of ``repro/training/trainer.py``).

The reference runs ``jit(shard_map(local_step))`` over a (data, model)
mesh; the port runs the same local step eagerly, one process per rank
(``launch/mesh.spawn(..., data=N)``), with explicit collectives:

  * the batch is split over the data ranks; gradients are averaged over
    them (``pmean``; the int8 ``quantized_pmean`` for leaves of at least
    2^16 elements under ``grad_comm_int8``);
  * Megatron TP over the model ranks: a sharded leaf's gradient is whole
    on its rank; a replicated leaf's (norms, the router, ...) is summed
    over the model ranks;
  * the forward pass is the serving stack's prefill (``logits_mode="all"``),
    so the ISO schedule is there at training time too (``mode="train_iso"``;
    ``"train"`` turns it off, the reference's default);
  * the TP reduces inside the forward are differentiable
    (``core/overlap.all_reduce_sum``) and their backward sums the
    cotangent over the model ranks, as ``lax.psum`` transposes under
    ``shard_map(check_vma=False)``: gradients at tp=M are M x tp=1's, and
    so is the gradient norm (ROADMAP queue C).

Parameters are the model's dict of tensors, updated IN PLACE.  The
optimizer sees them as the reference's leaves (``Leaf``): a layer leaf is
its P per-period tensors, stacked in the reference; its name is the
reference's ``keystr`` and its rank the stacked one (weight decay applies
to leaves of rank >= 2, so a layer's norm scales decay there, the final
norm's does not)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import Config
from repro_torch.core.overlap import AxisCtx, dp_psum
from repro_torch.core.quantized_collectives import quantized_pmean
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import TPGroup
from repro_torch.models import api
from repro_torch.models.decoder import shard_axis
from repro_torch.training.loss import sharded_xent
from repro_torch.training.optimizer import adamw_init, adamw_update, \
    warmup_cosine


@dataclass
class Leaf:
    """One leaf of the reference's parameter tree over the port's tensors:
    ``tensors`` is one tensor, or a layer leaf's one per period (stacked
    over periods in the reference)."""
    name: str                     # the reference's keystr
    tensors: List[torch.Tensor]
    sharded: bool                 # split over the model ranks
    ndim: int                     # its rank in the reference's layout

    @property
    def numel(self) -> int:
        return sum(t.numel() for t in self.tensors)

    def assign(self, flat: torch.Tensor) -> None:
        """Copy ``flat`` (numel,) into the tensors, in order, cast."""
        off = 0
        with torch.no_grad():
            for t in self.tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].reshape(t.shape))
                off += n


def path_key(path: str) -> str:
    """The last key of a keystr: ``"['attn']['wq']"`` -> ``"wq"``."""
    return path.rsplit("['", 1)[-1].rstrip("']") if path else ""


def param_leaves(params: Dict[str, Any]) -> List[Leaf]:
    """The reference's leaves of port params (this rank's shards; a
    whisper tree's two halves included), in the reference's flattening
    order, named by its ``keystr``."""
    leaves: List[Leaf] = []

    def add(path: str, parent: str, tensors: List[torch.Tensor],
            stacked: bool) -> None:
        name = path_key(path)
        t = tensors[0]
        leaves.append(Leaf(name=path, tensors=tensors,
                           sharded=shard_axis(name, parent, t.ndim)
                           is not None,
                           ndim=t.ndim + (1 if stacked else 0)))

    def walk(node, path: str, parent: str, layers: Optional[List] = None):
        for k in sorted(node):
            v = node[k]
            sub = f"{path}['{k}']"
            if k == "periods" and layers is None:
                for i, pos in enumerate(v):       # per position, per period
                    walk(pos[0], f"{sub}[{i}]", "", layers=pos)
            elif isinstance(v, dict):
                walk(v, sub, k, None if layers is None
                     else [lay[k] for lay in layers])
            elif layers is None:
                add(sub, parent, [v], False)
            else:
                add(sub, parent, [lay[k] for lay in layers], True)

    walk(params, "", "")
    return leaves


def make_axis_ctx(config: Config, group: Optional[TPGroup]) -> AxisCtx:
    """The rank's collectives: TP over ``group``'s model ranks, the
    gradient mean over its data ranks (``pods x data``; none without a
    group)."""
    p = config.parallel
    dp = p.pods * p.data
    if group is None:
        if p.model != 1 or dp != 1:
            raise ValueError(f"a {dp} x {p.model} mesh needs a rank group "
                             f"(launch/mesh.spawn(..., data=))")
        return AxisCtx(quantized_comm=config.iso.quantized_comm)
    if (group.dp, group.tp) != (dp, p.model):
        raise ValueError(f"ParallelConfig {dp} x {p.model}, rank group "
                         f"{group.dp} x {group.tp}")
    return group.axis_ctx(config.iso.quantized_comm)


def local_batch(batch: Dict[str, Any], ctx: AxisCtx, device
                ) -> Dict[str, torch.Tensor]:
    """This data rank's rows of a global batch (numpy or tensors) on
    ``device``, in their dtypes (fp32 frames and patches: the model casts
    or promotes them as the reference's does)."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        n = t.shape[0] // ctx.dp
        out[k] = t[ctx.dp_rank * n:(ctx.dp_rank + 1) * n].to(device)
    return out


def _grad_reduce(leaves: List[Leaf], grads: List[List[torch.Tensor]],
                 ctx: AxisCtx, int8: bool) -> List[List[torch.Tensor]]:
    """pmean over the data ranks everywhere (int8 for leaves of at least
    2^16 elements under ``int8``); a sum over the model ranks for
    replicated leaves (every TP rank saw a different partial path through
    them)."""
    out = []
    for leaf, gs in zip(leaves, grads):
        if ctx.dp_axes:
            if int8 and leaf.numel >= 1 << 16:
                # the reference's leaf: the periods' gradients stacked
                flat = quantized_pmean(
                    torch.cat([g.reshape(-1) for g in gs]), ctx.dp_group,
                    ctx.dp)
                gs = [f.reshape(g.shape) for f, g in zip(
                    torch.split(flat, [g.numel() for g in gs]), gs)]
            else:
                gs = [_all_reduce(g, ctx.dp_group) / ctx.dp for g in gs]
        if ctx.tp_axis is not None and not leaf.sharded:
            gs = [_all_reduce(g, ctx.group) for g in gs]
        out.append(gs)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _norm_sq(leaves: List[Leaf], grads, ctx: AxisCtx) -> torch.Tensor:
    """The squared global gradient norm: sharded leaves summed over the
    model ranks, replicated ones counted once."""
    dev = grads[0][0].device
    sharded = torch.zeros((), dtype=torch.float32, device=dev)
    repl = torch.zeros((), dtype=torch.float32, device=dev)
    for leaf, gs in zip(leaves, grads):
        s = sum(torch.sum(torch.square(g.float())) for g in gs)
        if ctx.tp_axis is not None and leaf.sharded:
            sharded = sharded + s
        else:
            repl = repl + s
    if ctx.tp_axis is not None:
        sharded = _all_reduce(sharded, ctx.group)
    return sharded + repl


def make_train_step(config: Config, group: Optional[TPGroup] = None
                    ) -> Callable:
    """The rank's step: ``step_fn(params, opt_state, batch, step) ->
    (loss, gnorm)``, fp32 0-d tensors, the loss averaged over the data
    ranks.  ``batch`` is the GLOBAL batch (numpy, as
    ``training/data.make_training_batch`` draws it); the step takes its data
    rank's rows.  ``params`` and ``opt_state`` are updated in place."""
    cfg = config.model
    rt = config.runtime
    ctx = make_axis_ctx(config, group)
    iso_train = config.iso if rt.mode == "train_iso" else \
        dataclasses.replace(config.iso, enabled=False)
    def loss_fn(params, batch):
        out = api.prefill(params, cfg, ctx, iso_train, batch,
                          logits_mode="all", remat=rt.remat)
        logits = out["logits_local"]
        if cfg.family == "vlm":
            logits = logits[:, batch["patches"].shape[1]:, :]
        loss = sharded_xent(logits, batch["labels"], ctx)
        return loss + 0.01 * out["moe_aux"]

    def grads_fn(params, batch):
        """(this rank's loss, the leaves, each leaf's local gradients):
        the backward pass alone, before any reduce over the ranks."""
        leaves = param_leaves(params)
        flat = [t for leaf in leaves for t in leaf.tensors]
        b = local_batch(batch, ctx, flat[0].device)
        for t in flat:
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, b)
            g_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for t in flat:
                t.requires_grad_(False)
        grads, i = [], 0
        for leaf in leaves:
            grads.append([torch.zeros_like(t) if g is None else g for t, g
                          in zip(leaf.tensors, g_flat[i:])])
            i += len(leaf.tensors)
        return loss.detach(), leaves, grads

    def step_fn(params, opt_state, batch, step: int):
        loss, leaves, grads = grads_fn(params, batch)
        flat = [t for leaf in leaves for t in leaf.tensors]
        dev = flat[0].device
        if ctx.dp_axes:
            loss = dp_psum(loss, ctx) / ctx.dp
        lr = warmup_cosine(step, rt.learning_rate, rt.warmup_steps,
                           rt.max_steps).to(dev)
        if rt.zero1:
            from repro_torch.training.zero import zero1_update_local
            # model-axis reduction only; ZeRO's reduce-scatter reduces over
            # data
            grads = [[_all_reduce(g, ctx.group) for g in gs]
                     if ctx.tp_axis is not None and not leaf.sharded else gs
                     for leaf, gs in zip(leaves, grads)]
            gnorm = zero1_update_local(
                leaves, grads, opt_state, ctx, lr=lr,
                weight_decay=rt.weight_decay, grad_clip=rt.grad_clip)
            return loss, gnorm
        grads = _grad_reduce(leaves, grads, ctx, rt.grad_comm_int8)
        nsq = _norm_sq(leaves, grads, ctx)
        adamw_update(flat, [g for gs in grads for g in gs], opt_state,
                     lr=lr, weight_decay=rt.weight_decay,
                     grad_clip=rt.grad_clip, global_norm_sq=nsq,
                     ndims=[leaf.ndim for leaf in leaves
                            for _ in leaf.tensors])
        return loss, torch.sqrt(nsq)

    step_fn.grads = grads_fn
    step_fn.ctx = ctx
    return step_fn


def init_train_state(config: Config, seed: int = 0,
                     group: Optional[TPGroup] = None, dtype=torch.bfloat16,
                     device=None, params=None):
    """(params, optimizer state) of this rank: its shard of the tp-built
    model from ``seed`` (or the given ``params``, this rank's shard), and
    zero AdamW moments, or under ZeRO-1 this data rank's slices of them."""
    cfg = config.model
    ctx = make_axis_ctx(config, group)
    if params is None:
        device = group.device if group is not None else resolve_device(device)
        params = api.init_params(seed, cfg, tp=ctx.tp, dtype=dtype,
                                 device=device,
                                 rank=ctx.rank if ctx.tp > 1 else None)
    leaves = param_leaves(params)
    if config.runtime.zero1:
        from repro_torch.training.zero import zero1_init_local
        return params, zero1_init_local(leaves, ctx.dp)
    return params, adamw_init([t for leaf in leaves for t in leaf.tensors])
