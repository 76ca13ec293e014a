"""Replay a TraceEvent stream back into counters (copy of
``repro/obs/replay.py``).

The conservation oracle: if the trace narration is complete, replaying it must
reproduce the registry's final counter values exactly (decode_tokens, grants,
preemptions, completions, ...) and page conservation must hold
(``pages_allocated - pages_freed == used_pages``).  tests/test_torch_obs.py
pins both.  Only works on an un-wrapped ring (no drops) —
``TraceRing.dropped == 0``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

from repro_torch.obs.trace import TraceEvent

# counter names replay can reconstruct; keys match the engine registries
REPLAYABLE = (
    "prefill_grants", "resumed_grants", "prefill_calls", "prefill_tokens",
    "decode_calls", "spec_calls", "decode_tokens", "spec_tokens",
    "prefill_samples", "ttft_n", "preemptions", "completed", "cow_copies",
    "prefix_shared_tokens", "migrations", "migrated_pages",
)


def replay_counters(events: Sequence[TraceEvent]) -> Dict[str, int]:
    """Counter values implied by the event stream.  Also returns the
    allocator-conservation pair ``pages_allocated``/``pages_freed``."""
    c: Dict[str, int] = defaultdict(int)
    for name in REPLAYABLE:
        c[name] = 0
    c["pages_allocated"] = 0
    c["pages_freed"] = 0
    for ev in events:
        k, p = ev.kind, ev.payload
        if k == "grant_commit":
            # scheduler "grant" issues are narration only: a grant can be
            # dropped (packmate eviction) and re-issued; commits are exact
            c["prefill_grants"] += 1
            if p.get("start", 0) > 0:
                c["resumed_grants"] += 1
        elif k == "prefill_call":
            c["prefill_calls"] += 1
            c["prefill_tokens"] += p.get("tokens", 0)
        elif k == "decode_call":
            c["decode_calls"] += 1
            if p.get("k", 1) > 1:
                c["spec_calls"] += 1
        elif k == "accept":
            n = p.get("n", 0)
            c["decode_tokens"] += n
            if p.get("spec"):
                c["spec_tokens"] += n
        elif k == "sample":
            c["prefill_samples"] += 1
            if p.get("first"):
                c["ttft_n"] += 1
        elif k == "evict":
            c["preemptions"] += 1
        elif k == "finish":
            c["completed"] += 1
        elif k == "cow":
            c["cow_copies"] += 1
        elif k == "adopt":
            c["prefix_shared_tokens"] += p.get("tokens", 0)
        elif k == "alloc":
            c["pages_allocated"] += p.get("n", 0)
        elif k == "free":
            c["pages_freed"] += p.get("n", 0)
        elif k == "migrate":
            # one span per PageTransfer on the DETACHING engine; n = distinct
            # pages moved.  The per-rid detach/attach instants and the
            # refcount-drop narration (rc_drop) are bookkeeping-neutral.
            c["migrations"] += 1
            c["migrated_pages"] += p.get("n", 0)
    return dict(c)
