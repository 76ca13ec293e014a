"""Structured trace events: a bounded ring the serving stack narrates into
(copy of ``repro/obs/trace.py``).

Every scheduler decision, allocator mutation and engine phase call appends one
``TraceEvent`` — cheap enough to leave on in production (one dataclass per
event; the ring drops the oldest events past ``capacity`` and counts what it
dropped, so memory is bounded no matter how long the engine runs).

Event vocabulary (payload keys in parentheses; -1 rid/slot = not applicable):

  scheduler   ``grant``   (start, n, padded, last)      one per prefill grant
              ``pack``    (rows, padded)                one per multi-row pack
              ``defer``   ()                            packmate-sharing defer
  allocator   ``alloc``   (n, free, used)               pages from free list
              ``free``    (n, free, used)               pages released
              ``rc_drop`` (n)                           sharer refcount drops
                                                        (no physical release)
              ``cow``     (old, new)                    copy-on-write copy
              ``adopt``   (n_pages, tokens)             prefix-share adoption
  engine      ``admit``   ()                            request -> slot
              ``grant_commit`` (start, n, last)        grant actually ran
              ``prefill_call`` (tokens, pad, rows, calls...)  span, dur > 0
              ``decode_call``  (k, active)              span, dur > 0
              ``sample``  (first, ttft?)                prefill-final sample
              ``accept``  (n, spec)                     tokens committed/slot
              ``spec_rollback`` (n)                     positions invalidated
              ``evict``   ()                            preemption victim
              ``finish``  ()                            request completed
              ``pool``    (used, free, frag)            per-step occupancy
  disagg      ``detach``  ()                            request exported out
              ``attach``  ()                            request imported in
              ``migrate`` (n, rids, us)                 one per PageTransfer,
                                                        n = distinct pages
  cost model  ``decision`` (point, chosen, static, ...) model-driven choice
              ``warning``  (what, reason, path)         degradation notice

``decision`` records every choice the measured cost model
(perf/costmodel.py) made instead of a static default — ``point`` is one of
``kv_splits``/``grant_cap``/``pack_rows``/``spec_gate``, ``chosen`` the
model's answer, ``static`` what the constant would have done, plus the
decision's inputs (depth, k, padded, expected_accept).  ``warning`` is
emitted exactly once per failed cost-table load (missing / malformed /
platform-mismatch) before falling back to static defaults.  Both are
bookkeeping-neutral: ``replay.replay_counters`` ignores kinds outside its
counter vocabulary, and the Chrome-trace exporter renders any unknown kind
as an instant.

``replay.replay_counters`` reconstructs the engine's counters from exactly
this vocabulary — the conservation tests pin that the narration is complete.
Timestamps are ``time.perf_counter()`` seconds (monotonic); spans carry their
START time plus ``dur`` so the Chrome-trace exporter can emit real slices.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TraceEvent:
    ts: float                          # perf_counter seconds (monotonic)
    kind: str
    rid: int = -1                      # request id, -1 when not applicable
    slot: int = -1                     # engine slot, -1 when not applicable
    dur: float = 0.0                   # span duration (0 = instant)
    payload: Dict[str, Any] = field(default_factory=dict)


class TraceRing:
    """Bounded event buffer.  ``enabled=False`` turns ``emit`` into a no-op
    (the obs-off configuration the overhead benchmark compares against)."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        assert capacity > 0
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0
        self._buf: deque = deque(maxlen=capacity)

    def emit(self, kind: str, rid: int = -1, slot: int = -1, dur: float = 0.0,
             ts: Optional[float] = None, **payload) -> None:
        if not self.enabled:
            return
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(TraceEvent(
            ts=time.perf_counter() if ts is None else ts,
            kind=kind, rid=rid, slot=slot, dur=dur, payload=payload))

    def events(self) -> List[TraceEvent]:
        """Insertion order (oldest surviving event first)."""
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)
