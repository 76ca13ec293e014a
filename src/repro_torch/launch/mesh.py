"""Tensor-parallel process groups (the port's counterpart of
``repro/launch/mesh.make_mesh``).

The reference runs TP as one program over a device mesh (``shard_map``); the
port runs one process per rank, joined by ``torch.distributed``.  ``spawn``
starts the ranks with the ``spawn`` start method (fork breaks once CUDA is
initialised), each rank calls ``fn(group, *args)`` with its ``TPGroup``, and
the parent gets every rank's return value back.

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
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.overlap import AxisCtx
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class TPGroup:
    """One rank's view of the tensor-parallel group."""
    rank: int
    tp: int
    device: torch.device
    backend: str
    group: Any = None            # the process group of the tp ranks

    def axis_ctx(self, quantized_comm: bool = False) -> AxisCtx:
        return AxisCtx(tp_axis="model", tp=self.tp, group=self.group,
                       rank=self.rank, quantized_comm=quantized_comm)


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
                f"tp={tp} needs {tp} cards, {torch.cuda.device_count()} "
                f"visible; to share one card ask for it explicitly "
                f"(device='cuda:0', backend='gloo')")
        return torch.device("cuda", rank), backend or "nccl"
    backend = backend or ("gloo" if tp > 1 else "nccl")
    if backend == "nccl" and tp > 1:
        raise ValueError("NCCL refuses two ranks on one card; pass "
                         "backend='gloo' to share it")
    return dev, backend


def init_tp_group(rank: int, tp: int, init_file: str, device=None,
                  backend: Optional[str] = None,
                  timeout_s: float = 600.0) -> TPGroup:
    """Join the default process group as rank ``rank`` of ``tp``."""
    dev, backend = rank_device(device, rank, tp, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # one intra-op thread per host rank: OpenMP workers spinning in
        # several processes starve gloo's progress threads
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=tp,
                            timeout=timedelta(seconds=timeout_s))
    return TPGroup(rank=rank, tp=tp, device=dev, backend=backend,
                   group=dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, tp: int, tmp: str, device, backend,
               timeout_s: float, args: Sequence) -> None:
    group = init_tp_group(rank, tp, os.path.join(tmp, "rendezvous"), device,
                          backend, timeout_s)
    try:
        result = fn(group, *args)
    finally:
        dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


def spawn(fn: Callable, tp: int, *, args: Sequence = (), device=None,
          backend: Optional[str] = None, timeout_s: float = 600.0
          ) -> List[Any]:
    """Run ``fn(group, *args)`` on ``tp`` fresh rank processes and return
    the ranks' results in rank order.  ``fn`` must be importable by name
    (module level) and its result picklable.  A rank that raises, or a run
    past ``timeout_s``, stops every rank and raises here."""
    rank_device(device, 0, tp, backend)           # refuse before starting
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tp, tmp, device, backend, timeout_s,
                              tuple(args)),
            nprocs=tp, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"tp={tp} ranks still running after "
                                   f"{timeout_s} s")
        results = []
        for r in range(tp):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
