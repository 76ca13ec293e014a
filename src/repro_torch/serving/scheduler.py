"""Token-budget continuous-batching scheduler, Sarathi-style chunked prefill
(copy of ``repro/serving/scheduler.py`` for the port's slice).

Prompts are split at admission with ``core/chunking.split_chunks``: the ISO
chunk is the scheduling quantum.  Each engine iteration the scheduler grants
whole chunks in policy order under ``prefill_token_budget``; consecutive
chunks of one request granted in the same step run as ONE forward call.
Policies: ``fcfs`` and ``priority``.  ``pack_grants`` groups a step's
grants of one bucket-padded length into packs, each run as one forward
call (batched prefill).  Preemption-by-eviction picks the lowest-priority
most-recently-arrived running request.  As in the reference, grants and
packs narrate themselves into an optional trace ring, and a measured cost
model (perf/costmodel.py) caps grant sizes and pack widths, each modeled
cap that binds logged as a ``decision`` event.  Phase routing
(``phase=``) serves disaggregation (serving/disagg.py): a ``prefill``
scheduler's engine runs no decode step, a ``decode`` scheduler grants no
prefill.
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
                whole: bool = False, *, tp: int = 1) -> Tuple[int, ...]:
    """ISO chunk boundaries for a prompt: the scheduling quanta.  ``tp`` is
    the engine's, the one its decoder splits each grant with (both on the
    default profile), so under ``split_policy="auto"`` the quanta are the
    chunks the decoder would cut the same length into.  (The reference
    calls ``split_chunks`` here with its defaults, tp=16 on a TPU profile,
    while its decoder passes the mesh's tp.)"""
    if whole:
        return (prompt_len,)
    return split_chunks(prompt_len, iso, cfg, tp=tp)


class TokenBudgetScheduler:
    """Pure bookkeeping: ordering, budget accounting and victim selection."""

    def __init__(self, policy: str = "fcfs", prefill_token_budget: int = 512,
                 grant_buckets: Optional[Tuple[int, ...]] = None, trace=None,
                 cost_model=None, phase: str = "mixed"):
        if policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown scheduler policy {policy!r}")
        if phase not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown scheduler phase {phase!r}")
        self.policy = policy
        # phase routing (disaggregated serving): a "prefill" scheduler
        # grants prefill chunks but its engine never decodes (finished
        # prefills are detached and migrated out); a "decode" scheduler
        # grants nothing and its engine never admits (requests arrive by
        # attach); "mixed" is the single engine
        self.phase = phase
        self.budget = max(1, prefill_token_budget)
        # optional obs.TraceRing: grant/pack decisions narrate themselves
        self.trace = trace
        self.grant_buckets = tuple(grant_buckets) if grant_buckets else None
        # measured cost model: the chunk cap is the bucket with the best
        # measured time per token (the remainder resumes next step, an exact
        # split), and pack widths are capped at the best measured time per
        # grant; both from the table alone, so the decision sequence is a
        # pure function of traffic
        self.cost_model = cost_model
        self._grant_cap: Optional[int] = None
        if cost_model is not None:
            cap = cost_model.grant_cap(self.grant_buckets)
            if cap is not None:
                self._grant_cap = max(1, int(cap))
        self._pack_caps: Dict[int, int] = {}  # padded len -> modeled rows
        self._arrival: Dict[int, int] = {}
        self._priority: Dict[int, int] = {}
        self._clock = 0
        self.waiting: List[int] = []          # rids, un-ordered; sorted on use

    # ---- phase routing ----------------------------------------------------
    @property
    def runs_prefill(self) -> bool:
        return self.phase != "decode"

    @property
    def runs_decode(self) -> bool:
        return self.phase != "prefill"

    # ---- queue ------------------------------------------------------------
    def add(self, rid: int, priority: int = 0) -> None:
        if rid not in self._arrival:          # preserve arrival on re-queue
            self._arrival[rid] = self._clock
            self._clock += 1
        self._priority[rid] = priority
        self.waiting.append(rid)

    def register(self, rid: int, priority: int = 0) -> None:
        """Arrival and priority bookkeeping without queueing: an attached
        (migrated-in) request is already resident, but ``pick_victim`` and
        ``order`` need its key; registration order is the migration order,
        which the router keeps in policy order."""
        if rid not in self._arrival:
            self._arrival[rid] = self._clock
            self._clock += 1
        self._priority[rid] = priority

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
        starve.  A decode-phase scheduler grants nothing."""
        if not self.runs_prefill:
            return []
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
            if self._grant_cap is not None and take > self._grant_cap:
                # modeled chunk cap: the grant's tail resumes next step
                if self.trace is not None:
                    self.trace.emit("decision", rid=rid, point="grant_cap",
                                    chosen=self._grant_cap, static=take)
                take = self._grant_cap
            remaining = max(0, remaining - take)
            padded = take if self.grant_buckets is None else \
                round_to_bucket(take, self.grant_buckets)
            g = PrefillGrant(rid=rid, start=done, n_tokens=take,
                             last=done + take >= ends[-1], padded=padded)
            grants.append(g)
            if self.trace is not None:
                self.trace.emit("grant", rid=rid, start=g.start, n=g.n_tokens,
                                padded=g.padded, last=g.last)
            if remaining == 0:
                break
        return grants

    def pack_grants(self, grants: Sequence[PrefillGrant], max_rows: int = 0
                    ) -> List[List[PrefillGrant]]:
        """Group compatible grants into packs, one forward call each.

        Grants are sorted by the policy key (the order ``grant_prefill``
        emits, re-applied so a caller's order cannot change the packs), then
        grouped greedily by identical ``padded`` length; a pack closes at
        ``max_rows``, and packs come out in the policy order of their first
        member.  ``max_rows <= 1`` gives singletons (the batch-1 path)."""
        if max_rows <= 1:
            return [[g] for g in grants]
        ordered = sorted(grants, key=lambda g: self._key(g.rid))
        packs: List[List[PrefillGrant]] = []
        open_by_len: Dict[int, int] = {}      # padded length -> pack index
        for g in ordered:
            limit = self._pack_limit(g.padded, max_rows)
            idx = open_by_len.get(g.padded)
            if idx is None or len(packs[idx]) >= limit:
                open_by_len[g.padded] = len(packs)
                packs.append([g])
            else:
                packs[idx].append(g)
        if self.trace is not None:
            for pack in packs:
                if len(pack) > 1:
                    self.trace.emit("pack", rid=pack[0].rid,
                                    rows=len(pack), padded=pack[0].padded)
        return packs

    def _pack_limit(self, padded: int, max_rows: int) -> int:
        """Row cap for packs of ``padded``-token grants: the measured row
        bucket with the best time per grant when a cost model is loaded
        (memoised per padded length, logged once as a ``decision`` when it
        binds), else ``max_rows``.  Packing changes call grouping only, so
        a modeled cap can move speed, never tokens."""
        if self.cost_model is None:
            return max_rows
        cap = self._pack_caps.get(padded)
        if cap is None:
            modeled = self.cost_model.pack_rows(padded)
            cap = max_rows if modeled is None else max(1, int(modeled))
            self._pack_caps[padded] = cap
            if self.trace is not None and cap < max_rows:
                self.trace.emit("decision", point="pack_rows", chosen=cap,
                                static=max_rows, padded=padded)
        return min(cap, max_rows)

    def pick_victim(self, running: Sequence[int], protect: Sequence[int] = ()
                    ) -> Optional[int]:
        """Eviction victim: reverse policy order (lowest priority, youngest)."""
        protected = set(protect)
        cands = [r for r in running if r not in protected]
        if not cands:
            return None
        return max(cands, key=self._key)
