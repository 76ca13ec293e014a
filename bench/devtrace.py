"""Reading a ``torch.profiler`` trace (CPU and CUDA activities) of the
profiled slice: the device's intervals (kernels, copies, fills), their
union, the time by kernel name, and the device's idle gaps labelled by
what the host was doing.

A gap is labelled by the benchmark's own host range that holds its
midpoint (``bench/step`` around ``PagedEngine.step``, ``bench/client``
around the clients' work) and the innermost profiled host operation
inside it, if any (``bench/step > aten::copy_``); a gap outside every
range is ``host: untraced``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

STEP_RANGE = "bench/step"
CLIENT_RANGE = "bench/client"


class Slice:
    """What a profiled slice showed.  Times in seconds."""

    def __init__(self, prof, wall_s: float):
        self.wall_s = wall_s
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.name.startswith("bench/"):
                # the host ranges, and their copies on the device's row
                if e.device_type != DeviceType.CUDA:
                    host.append((tr.start, tr.end, e.name))
                continue
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            else:
                host.append((tr.start, tr.end, e.name))
        dev.sort()
        self.n = len(dev)
        busy, end = 0.0, float("-inf")
        gaps: List[Tuple[float, float]] = []
        for a, b, _ in dev:                 # union of the intervals
            if a > end and end > float("-inf"):
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        self.busy_s = busy / 1e6
        self.span_s = (end - dev[0][0]) / 1e6 if dev else 0.0
        by_name: Dict[str, float] = {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        self.by_name = by_name
        self.gap_labels = self._label(gaps, host)

    @staticmethod
    def _label(gaps, host) -> Dict[str, float]:
        ranges = sorted((a, b, n) for a, b, n in host
                        if n in (STEP_RANGE, CLIENT_RANGE))
        starts = [r[0] for r in ranges]
        ops = sorted((a, b, n) for a, b, n in host
                     if n not in (STEP_RANGE, CLIENT_RANGE))
        op_starts = [o[0] for o in ops]
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = "host: untraced"
            if i >= 0 and ranges[i][1] >= mid:
                label = ranges[i][2]
                # the innermost host op holding the midpoint: the latest
                # start among those still open, over the few before it
                j = bisect.bisect_right(op_starts, mid) - 1
                best = None
                for k in range(j, max(-1, j - 64), -1):
                    oa, ob, on = ops[k]
                    if oa < ranges[i][0]:
                        break
                    if ob >= mid:
                        best = on
                        break
                label = f"{label} > {best}" if best else \
                    f"{label}: host code"
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
        return out

    def kernel_seconds(self, pattern: str) -> float:
        """Device time of the intervals whose name holds ``pattern``."""
        return sum(t for n, t in self.by_name.items() if pattern in n)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gap_labels.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], t] for n, t in ops],
                "idle_gaps": [[n[:200], t] for n, t in gaps]}
