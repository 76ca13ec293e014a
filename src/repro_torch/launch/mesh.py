"""Tensor- and data-parallel process groups (the port's counterpart of
``repro/launch/mesh.make_mesh``).

The reference runs TP as one program over a device mesh (``shard_map``); the
port runs one process per rank, joined by ``torch.distributed``.  ``spawn``
starts the ranks with the ``spawn`` start method (fork breaks once CUDA is
initialised), each rank calls ``fn(group, *args)`` with its ``TPGroup``, and
the parent gets every rank's return value back.  ``spawn(..., data=N)``
starts the (data, model) grid of training, N x tp ranks in the reference's
device order (``model`` the fast axis: global rank ``d * tp + m``), with a
process group for each TP row and each data-parallel column.

``spawn(..., disagg=True)`` starts the two rank groups of disaggregated
serving under TP (the counterpart of the reference's ``disagg_meshes``, two
disjoint (1, tp) meshes): 2 x tp ranks, global ranks 0..tp-1 the prefill
group and tp..2tp-1 the decode group, each rank with a ``DisaggGroup``: its
role, a ``TPGroup`` over its own group for its engine, and the global rank
of its peer (prefill rank m <-> decode rank m, which hold the same kv-head
shard).  The world group joins all 2 x tp ranks for the router's
exchanges.  Devices follow the rules below with 2 x tp ranks: bare
``cuda`` needs 2 x tp cards (never run: every chip run so far had one).

Device and backend follow each other:

  * ``device="cuda"``: rank r runs on ``cuda:r`` over NCCL; asking for more
    ranks than cards raises.
  * ``device="cpu"``: every rank on the host, over gloo.
  * ``device="cuda:i"`` with ``backend="gloo"``: every rank shares card i.
    NCCL refuses two ranks on one device, so this is only asked for
    explicitly; gloo moves each collective through host memory, so such a
    run checks the sharded path on real CUDA tensors but shows no overlap.

Ranks meet through a ``file://`` rendezvous in a fresh temporary directory,
so concurrent runs never contend for a port.

``disagg_devices`` places the two engines of disaggregated serving at tp=1,
in one process.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.overlap import AxisCtx
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class TPGroup:
    """One rank's view of the tensor-parallel group, and of the
    data-parallel group of a (data, model) grid (``dp`` 1: none)."""
    rank: int
    tp: int
    device: torch.device
    backend: str
    group: Any = None            # the process group of the tp ranks
    dp: int = 1
    dp_rank: int = 0
    dp_group: Any = None         # the process group of the dp ranks

    def axis_ctx(self, quantized_comm: bool = False) -> AxisCtx:
        dp = dict(dp_axes=("data",), dp=self.dp, dp_group=self.dp_group,
                  dp_rank=self.dp_rank) if self.dp > 1 else {}
        return AxisCtx(tp_axis="model", tp=self.tp, group=self.group,
                       rank=self.rank, quantized_comm=quantized_comm, **dp)


def rank_device(device, rank: int, tp: int,
                backend: Optional[str] = None) -> tuple:
    """(device, backend) of rank ``rank`` of ``tp`` (see module doc)."""
    asked = torch.device("cuda" if device is None else device)
    dev = resolve_device(asked)
    if dev.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: use gloo")
        return dev, backend
    if asked.index is None:
        if tp > torch.cuda.device_count():
            raise ValueError(
                f"{tp} ranks over NCCL needs {tp} cards, "
                f"{torch.cuda.device_count()} visible; to share one card ask "
                f"for it explicitly (device='cuda:0', backend='gloo')")
        return torch.device("cuda", rank), backend or "nccl"
    backend = backend or ("gloo" if tp > 1 else "nccl")
    if backend == "nccl" and tp > 1:
        raise ValueError("NCCL refuses two ranks on one card; pass "
                         "backend='gloo' to share it")
    return dev, backend


def _join(rank: int, world: int, init_file: str, device, backend,
          timeout_s: float) -> tuple:
    """Join the default process group as global rank ``rank`` of
    ``world``: (device, backend)."""
    dev, backend = rank_device(device, rank, world, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # one intra-op thread per host rank: OpenMP workers spinning in
        # several processes starve gloo's progress threads
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return dev, backend


def init_tp_group(rank: int, tp: int, init_file: str, device=None,
                  backend: Optional[str] = None,
                  timeout_s: float = 600.0, data: int = 1) -> TPGroup:
    """Join the default process group as global rank ``rank`` of the
    ``data`` x ``tp`` grid (``data`` 1: rank ``rank`` of ``tp``)."""
    dev, backend = _join(rank, data * tp, init_file, device, backend,
                         timeout_s)
    if data == 1:
        return TPGroup(rank=rank, tp=tp, device=dev, backend=backend,
                       group=dist.group.WORLD)
    # every rank creates every group, in one order: the TP rows, then the
    # data-parallel columns
    d, m = divmod(rank, tp)
    rows = [dist.new_group([r * tp + j for j in range(tp)])
            for r in range(data)]
    cols = [dist.new_group([r * tp + j for r in range(data)])
            for j in range(tp)]
    return TPGroup(rank=m, tp=tp, device=dev, backend=backend, group=rows[d],
                   dp=data, dp_rank=d, dp_group=cols[m])


@dataclass(frozen=True)
class DisaggGroup:
    """One rank's view of disaggregated serving under TP: 2 x tp ranks,
    the prefill group (global ranks 0..tp-1) and the decode group
    (tp..2tp-1).  ``tp_group`` is this rank's engine group; ``peer`` the
    global rank holding the same kv-head shard in the other group;
    ``world`` the group of all 2 x tp ranks, over which the router
    exchanges its decisions (the leader, prefill rank 0, is global rank
    0)."""
    role: str                    # "prefill" or "decode"
    tp_group: TPGroup
    global_rank: int
    peer: int
    world: Any = None

    ROLES = ("prefill", "decode")

    @property
    def tp(self) -> int:
        return self.tp_group.tp

    @property
    def device(self) -> torch.device:
        return self.tp_group.device

    @property
    def backend(self) -> str:
        return self.tp_group.backend


def init_disagg_group(rank: int, tp: int, init_file: str, device=None,
                      backend: Optional[str] = None,
                      timeout_s: float = 600.0) -> DisaggGroup:
    """Join the default process group as global rank ``rank`` of the two
    rank groups of disaggregated serving (module doc)."""
    dev, backend = _join(rank, 2 * tp, init_file, device, backend, timeout_s)
    # every rank creates every group, in one order: prefill, then decode
    groups = [dist.new_group([g * tp + m for m in range(tp)])
              for g in range(2)]
    g, m = divmod(rank, tp)
    return DisaggGroup(role=DisaggGroup.ROLES[g],
                       tp_group=TPGroup(rank=m, tp=tp, device=dev,
                                        backend=backend, group=groups[g]),
                       global_rank=rank, peer=(1 - g) * tp + m,
                       world=dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, tp: int, tmp: str, device, backend,
               timeout_s: float, args: Sequence, data: int = 1,
               disagg: bool = False) -> None:
    init_file = os.path.join(tmp, "rendezvous")
    group = init_disagg_group(rank, tp, init_file, device, backend,
                              timeout_s) if disagg else \
        init_tp_group(rank, tp, init_file, device, backend, timeout_s, data)
    try:
        result = fn(group, *args)
    finally:
        dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


def spawn(fn: Callable, tp: int, *, args: Sequence = (), device=None,
          backend: Optional[str] = None, timeout_s: float = 600.0,
          data: int = 1, disagg: bool = False) -> List[Any]:
    """Run ``fn(group, *args)`` on ``data * tp`` fresh rank processes (2 x
    tp with ``disagg``, each ``group`` then a ``DisaggGroup``) and return
    the ranks' results in global rank order (``d * tp + m``; with
    ``disagg`` the prefill ranks, then the decode ranks).  ``fn`` must be
    importable by name (module level) and its result picklable.  A rank
    that raises, or a run past ``timeout_s``, stops every rank and raises
    here."""
    if disagg and data != 1:
        raise ValueError("disagg spawns two TP groups; data must be 1")
    world = 2 * tp if disagg else data * tp
    rank_device(device, 0, world, backend)        # refuse before starting
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tp, tmp, device, backend, timeout_s,
                              tuple(args), data, disagg),
            nprocs=world, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks (tp={tp}) still running "
                                   f"after {timeout_s} s")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def disagg_devices(device=None) -> Tuple[torch.device, torch.device, bool]:
    """(prefill device, decode device, shared) for disaggregated serving at
    tp=1: two disjoint cards where two are visible (``shared`` False), else
    the one card twice (True, both engines then use one set of weights);
    on the host, the CPU twice.  ``device`` as ``resolve_device`` takes it;
    a card named with an index is used for both engines."""
    asked = torch.device("cuda" if device is None else device)
    dev = resolve_device(asked)
    if dev.type == "cpu":
        return dev, dev, True
    if asked.index is None and torch.cuda.device_count() >= 2:
        return torch.device("cuda", 0), torch.device("cuda", 1), False
    dev = torch.device("cuda", 0 if asked.index is None else asked.index)
    return dev, dev, True
