"""``torch.profiler`` hooks: line device timelines up with the host trace
(the port's counterpart of ``repro/obs/jaxprof.py``).

``annotate(name)`` wraps the engine's closure calls.  While a profile is
active it returns ``torch.profiler.record_function(name)``, a host range
named like the engine's own ``prefill_call``/``decode_call`` events
(``prefill/T=…``, ``prefill/T=…x…``, ``decode/K=…/S=…``), so the two
traces can be lined up by eye in Perfetto.  With no active profile it
returns a shared nullcontext: the hot path pays one module-global read,
nothing else.

PyTorch has no counterpart of the TPU trace annotation's device-side
slice: the names mark host ranges only.  The kernels a range launches (one
CUDA-graph replay on the card at tp=1) show up on the CUDA stream,
linked to the launch inside the range by their correlation id.

``start(dir)`` / ``stop()`` wrap a ``torch.profiler.profile`` with CPU
activities, and CUDA ones where a card is present; ``stop`` writes its
Chrome trace into ``dir`` (exposed in launch/serve.py as ``--profile
DIR``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

_prof = None
_dir: Optional[str] = None
_NULL = contextlib.nullcontext()
TRACE_FILE = "torch_trace.json"


def profiling_active() -> bool:
    return _prof is not None


def annotate(name: str):
    if _prof is None:
        return _NULL
    import torch
    return torch.profiler.record_function(name)


def start(log_dir: str) -> None:
    global _prof, _dir
    import torch
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
