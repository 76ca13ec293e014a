"""Percentiles, censoring and rates over all requests of a window."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of every value, linearly
    interpolated between closest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(sent: Iterable[float], first: Iterable[Optional[float]],
          window_end: float) -> List[float]:
    """Each request's time to first token; one with no first token by the
    window's end counts with its wait so far (censored at the end)."""
    return [(f if f is not None else window_end) - s
            for s, f in zip(sent, first)]


def gaps(stamps: Sequence[float], window_start: float, window_end: float,
         open_tail: bool) -> List[float]:
    """The gaps between one request's consecutive token stamps that end
    inside the window and begin at or after its start; with ``open_tail``
    (the request still owes tokens at the close), the wait from its last
    stamp to the close counts as one more gap, so a stall cannot hide."""
    out = [b - a for a, b in zip(stamps, stamps[1:])
           if a >= window_start and b <= window_end]
    if open_tail and stamps:
        out.append(window_end - stamps[-1])
    return out


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds


def window_ttfts(run) -> List[float]:
    """TTFT of every request sent in ``run``'s window, censored at its
    close."""
    sent = [r for r in run.requests if run.t0 <= r.sent <= run.t1]
    firsts = [r.first if r.first is not None and r.first <= run.t1 else None
              for r in sent]
    return ttfts([r.sent for r in sent], firsts, run.t1)


def window_gaps(run) -> List[float]:
    """Every inter-token gap of ``run``'s window, each still-open
    request's wait since its last token included."""
    out: List[float] = []
    for r in run.requests:
        open_tail = r.done is None or r.done > run.t1
        out += gaps([t for t in r.stamps if t <= run.t1], run.t0, run.t1,
                    open_tail)
    return out
