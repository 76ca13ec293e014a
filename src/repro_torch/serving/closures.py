"""Compiled step closures: the port's counterpart of one ``jax.jit``
executable, shared by the dense-cache ``Engine`` (serving/engine.py) and
``PagedEngine`` (serving/paged_engine.py).

A ``StepClosure`` holds static input buffers of one key's shape and the
step's body over them.  A step copies its host arrays into the buffers
(``stage``) and calls the closure.  On the card at tp=1 an engine captures
the body once in a ``torch.cuda.CUDAGraph`` (every graph of the engine
drawing on one shared memory pool) and each call is one replay; elsewhere
(the CPU, a TP engine over gloo, ``cuda_graphs=False``) the same body runs
eagerly over the same buffers.  Nothing on a captured body may read a
tensor back to the host (``.item()``, ``int(t)``, ``.cpu()``,
``torch.tensor(...)``): a graph would replay the value read at capture.
A failed capture or replay raises; nothing falls back to the eager body.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import synchronize
from repro_torch.kernels import native


class StepClosure:
    """One compiled step: static input buffers of a fixed shape, the step's
    body over them, and, once ``capture`` has run, the CUDA graph of that
    body (the port's counterpart of one ``jax.jit`` executable).

    ``stage`` copies host arrays into the buffers (on the card through
    pinned staging buffers, without waiting: the engine fences every call
    of a closure with array inputs before it stages the next).  Calling the
    closure runs the body, or replays the graph and returns its static
    output, which the next replay of any graph of the shared pool may
    overwrite: callers copy out what they keep first.  A replay adds to the
    kernels' launch counters the launches its capture recorded, so the
    counts stay those of the kernels that ran."""

    def __init__(self, buffers: Dict[str, torch.Tensor], body,
                 graphed: bool, mutates: Tuple[torch.Tensor, ...] = ()):
        self.inputs = buffers
        # state the body advances in place (the recurrent slots): the
        # capture's warm-up must leave it as it found it
        self._mutates = mutates
        self._body = torch.no_grad()(body)
        self.graphed = graphed
        on_card = next(iter(buffers.values())).device.type == "cuda"
        self._pinned = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in buffers.items() if v.ndim} \
            if on_card else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._launches: Dict[str, int] = {}

    def stage(self, **host) -> None:
        """Copy host arrays (numpy or ints) into the input buffers.  On the
        card a 0-d buffer is filled with its int by a kernel argument, not
        through a pinned buffer, so closures that run back to back without a
        fence between them (the page copies of copy-on-write) never
        overwrite a pinned buffer whose copy is still queued."""
        for name, value in host.items():
            if self._pinned is None:
                self.inputs[name].numpy()[...] = value
            elif name not in self._pinned:              # a 0-d buffer
                self.inputs[name].fill_(int(value))
            else:
                pin = self._pinned[name]
                pin.numpy()[...] = value
                self.inputs[name].copy_(pin, non_blocking=True)

    def capture(self, side: torch.cuda.Stream, pool) -> float:
        """Record the body in a CUDA graph drawing on the memory ``pool``;
        returns the seconds it took.  The body first runs once on the side
        stream ``side`` over the staged inputs, so the kernels' library is
        loaded, their attributes are set and B1's arrival counters are
        grown before the capture, which must allocate nothing that outlives
        it.  The warm-up writes the KV the replay then writes again; the
        state it advances (``mutates``) is put back, so the replay that
        follows advances it once."""
        dev = next(iter(self.inputs.values())).device
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        saved = [t.clone() for t in self._mutates]
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()
        main.wait_stream(side)
        for t, old in zip(self._mutates, saved):
            t.copy_(old)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = native.launch_counts()
        with torch.cuda.graph(graph, pool=pool):
            out = self._body()
        # the capture recorded these launches; replays make them
        after = native.launch_counts()
        self._launches = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        native.add_launches({k: -n for k, n in self._launches.items()})
        self.graph, self._out = graph, out
        synchronize(dev)
        return time.perf_counter() - t0

    def __call__(self):
        if not self.graphed:
            return self._body()
        if self.graph is None:
            raise RuntimeError("a graphed step closure was called before "
                               "its capture")
        self.graph.replay()
        native.add_launches(self._launches)
        return self._out
