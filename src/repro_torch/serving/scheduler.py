"""Token-budget continuous-batching scheduler, Sarathi-style chunked prefill
(copy of ``repro/serving/scheduler.py`` for the port's slice).

Prompts are split at admission with ``core/chunking.split_chunks``: the ISO
chunk is the scheduling quantum.  Each engine iteration the scheduler grants
whole chunks in policy order under ``prefill_token_budget``; consecutive
chunks of one request granted in the same step run as ONE forward call.
Policies: ``fcfs`` and ``priority``.  Preemption-by-eviction picks the
lowest-priority most-recently-arrived running request.  The reference's
grant packing (batched prefill), cost-model caps, trace narration and phase
routing (disaggregation) are not part of the slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.config import ISOConfig, ModelConfig
from repro_torch.core.chunking import round_to_bucket, split_chunks


@dataclass
class PrefillGrant:
    """One step's prefill work for one request."""
    rid: int
    start: int                 # tokens already prefilled (absolute offset)
    n_tokens: int              # tokens granted this step
    last: bool                 # True if this grant finishes the prompt
    padded: int = 0            # bucket-rounded grant length (== n_tokens
                               # when bucketing is off)


def plan_chunks(prompt_len: int, iso: ISOConfig, cfg: ModelConfig,
                whole: bool = False) -> Tuple[int, ...]:
    """ISO chunk boundaries for a prompt: the scheduling quanta."""
    if whole:
        return (prompt_len,)
    return split_chunks(prompt_len, iso, cfg)


class TokenBudgetScheduler:
    """Pure bookkeeping: ordering, budget accounting and victim selection."""

    def __init__(self, policy: str = "fcfs", prefill_token_budget: int = 512,
                 grant_buckets: Optional[Tuple[int, ...]] = None):
        if policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown scheduler policy {policy!r}")
        self.policy = policy
        self.budget = max(1, prefill_token_budget)
        self.grant_buckets = tuple(grant_buckets) if grant_buckets else None
        self._arrival: Dict[int, int] = {}
        self._priority: Dict[int, int] = {}
        self._clock = 0
        self.waiting: List[int] = []          # rids, un-ordered; sorted on use

    # ---- queue ------------------------------------------------------------
    def add(self, rid: int, priority: int = 0) -> None:
        if rid not in self._arrival:          # preserve arrival on re-queue
            self._arrival[rid] = self._clock
            self._clock += 1
        self._priority[rid] = priority
        self.waiting.append(rid)

    def forget(self, rid: int) -> None:
        """Drop every trace of ``rid``, its waiting-queue entry included."""
        self._arrival.pop(rid, None)
        self._priority.pop(rid, None)
        while rid in self.waiting:
            self.waiting.remove(rid)

    def _key(self, rid: int):
        if self.policy == "priority":
            return (-self._priority.get(rid, 0), self._arrival[rid])
        return (self._arrival[rid],)

    def order(self, rids: Sequence[int]) -> List[int]:
        return sorted(rids, key=self._key)

    def pop_waiting(self) -> Optional[int]:
        if not self.waiting:
            return None
        rid = min(self.waiting, key=self._key)
        self.waiting.remove(rid)
        return rid

    def requeue_front(self, rid: int) -> None:
        """Preempted request: back to waiting, arrival preserved; idempotent."""
        if rid not in self.waiting:
            self.waiting.append(rid)

    # ---- per-step planning -------------------------------------------------
    def grant_prefill(self, prefill_states: Sequence[Tuple[int, int, Tuple[int, ...]]]
                      ) -> List[PrefillGrant]:
        """Distribute this step's token budget over running prefills.

        ``prefill_states``: (rid, tokens_done, chunk_plan) for every running
        request with prompt tokens remaining.  Grants whole chunks in policy
        order; the head-of-line request always gets at least its next chunk
        even past the budget, so a chunk bigger than the budget cannot
        starve."""
        by_rid = {rid: (done, plan) for rid, done, plan in prefill_states}
        grants: List[PrefillGrant] = []
        remaining = self.budget
        for rid in self.order(list(by_rid)):
            done, plan = by_rid[rid]
            ends, acc = [], 0
            for c in plan:
                acc += c
                ends.append(acc)
            assert done < ends[-1], (rid, done, plan)
            take, prev = 0, done
            for e in ends:
                if e <= done:
                    continue
                chunk = e - prev
                head_of_line = not grants and take == 0
                if take + chunk > remaining and not head_of_line:
                    break
                take += chunk
                prev = e
            if take == 0:
                continue                      # budget exhausted for non-head
            remaining = max(0, remaining - take)
            padded = take if self.grant_buckets is None else \
                round_to_bucket(take, self.grant_buckets)
            grants.append(PrefillGrant(rid=rid, start=done, n_tokens=take,
                                       last=done + take >= ends[-1],
                                       padded=padded))
            if remaining == 0:
                break
        return grants

    def pick_victim(self, running: Sequence[int], protect: Sequence[int] = ()
                    ) -> Optional[int]:
        """Eviction victim: reverse policy order (lowest priority, youngest)."""
        protected = set(protect)
        cands = [r for r in running if r not in protected]
        if not cands:
            return None
        return max(cands, key=self._key)
