"""``torch.profiler`` hooks: line device timelines up with the host trace
(the port's counterpart of ``repro/obs/jaxprof.py``).

One mechanism, ``Span``: a named stretch of host code that, while any
``torch.profiler`` profile records on this process (``recording()``, one
flag read, whoever started the profile), puts a host range of its name
around the stretch.  That range lands on the profiler's own clock, the one
its CUDA intervals use, so an idle gap of the card can be put down to the
host code the range names.  It is a host op's range
(``torch._C._profiler._RecordFunctionFast``), not a ``record_function``
user annotation: the profiler gives a user annotation a device-side copy
spanning the kernels launched inside it, which a reader of the device's
intervals would count as device work.  With no profile recording a span
calls nothing in the profiler: it costs two ``perf_counter`` reads and one
add into each of its counters (``registry.Counter``), which hold its host
seconds whether or not a profile records.

Spans that share a ``tile`` (a one-item list: the span now open) tile a
host loop: entering one pauses the open one, which resumes on exit, so
their ranges never nest in one another and their counters add up to the
loop's time.  ``PagedEngine.step`` tiles each step this way
(``engine/schedule``, ``engine/capture``, ``engine/{prefill,decode}.launch``
and ``.wait``, ``engine/logits.to_host``, ``engine/sample``).

``annotate(name)`` is a span with no counter and no tile: the closure-call
ranges (``prefill/T=…``, ``prefill/T=…x…``, ``decode/K=…/S=…``, named like
the engines' ``prefill_call``/``decode_call`` events), which nest inside
the launch spans and carry each call's shapes.  PyTorch has no counterpart
of the TPU trace annotation's device-side slice: the names mark host ranges
only.  The kernels a range launches (one CUDA-graph replay on the card at
tp=1) show up on the CUDA stream, linked to the launch inside the range by
their correlation id.

``start(dir)`` / ``stop()`` wrap a ``torch.profiler.profile`` with CPU
activities, and CUDA ones where a card is present; ``stop`` writes its
Chrome trace into ``dir`` (exposed in launch/serve.py as ``--profile
DIR``).
"""
from __future__ import annotations

import os
from time import perf_counter
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_prof = None
_dir: Optional[str] = None
TRACE_FILE = "torch_trace.json"


def recording() -> bool:
    """True while any ``torch.profiler`` profile records on this process
    (the flag ``torch.autograd.profiler`` sets at a profile's start)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """``with span:`` times its body into ``counters`` and, while a profile
    records, marks it with a range ``name``.  ``tile``: a one-item list
    shared by spans that tile one loop (module doc).  ``t0`` and ``dt`` hold
    the start and length of the last stretch.  A span is not re-entered
    while it is open."""
    __slots__ = ("name", "counters", "tile", "t0", "dt", "_range", "_outer")

    def __init__(self, name: str, *counters, tile: Optional[List] = None):
        self.name = name
        self.counters = counters
        self.tile = tile
        self.t0 = self.dt = 0.0
        self._range = self._outer = None

    def _open(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.t0 = perf_counter()

    def _close(self) -> None:
        self.dt = dt = perf_counter() - self.t0
        for c in self.counters:
            c.value += dt
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self) -> "Span":
        if self.tile is not None:
            self._outer = outer = self.tile[0]
            if outer is not None:
                outer._close()
            self.tile[0] = self
        self._open()
        return self

    def __exit__(self, *exc) -> None:
        self._close()
        if self.tile is not None:
            self.tile[0] = outer = self._outer
            if outer is not None:
                outer._open()


def annotate(name: str) -> Span:
    return Span(name)


def start(log_dir: str) -> None:
    global _prof, _dir
    from torch.profiler import ProfilerActivity
    if _prof is not None:
        raise RuntimeError("a torch.profiler profile is already active")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _prof, _dir = prof, log_dir


def stop() -> Optional[str]:
    """End the active profile and write its Chrome trace; returns the
    file's path (None when no profile was active)."""
    global _prof, _dir
    if _prof is None:
        return None
    prof, log_dir = _prof, _dir
    _prof = _dir = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path
