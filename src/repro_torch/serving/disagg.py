"""Disaggregated prefill/decode serving: two engines, KV pages migrate (port
of ``repro/serving/disagg.py``).

Prefill is compute-bound and decode memory-bound, so serving both from one
engine makes each phase inherit the other's batching compromises.  Here:

  * a ``phase="prefill"`` ``PagedEngine`` admits requests and runs chunked
    prefill only (its scheduler never plans a decode step);
  * a ``phase="decode"`` ``PagedEngine`` decodes only (it never admits: its
    requests arrive by ``attach_requests``);
  * the ``DisaggRouter`` moves each request between them once its prompt is
    resident: ``PagedEngine.detach_requests`` exports the KV pages and the
    lifecycle state as a ``PageTransfer`` (host arrays and plain records),
    and ``attach_requests`` adopts it into the decode pool at remapped page
    ids, writing the pool in place.

Greedy token streams equal single-engine serving's: sampling is a function
of (seed, step index), prefill and decode are row-independent, and
migration copies committed KV bit for bit.

Flow control: when the decode pool cannot host the next migration (no free
slot, or fewer free pages than the transfer's distinct pages) the request
stays on the prefill engine, prefilled and holding its pages, until
decode-side completions free room.  A transfer that was detached and then
fails to attach (``OutOfPages`` is atomic) queues on the host and retries
with bounded backoff.  Neither path preempts a decode-resident request,
loses tokens or raises.  Decode-side preemption victims bounce back to the
prefill engine in recompute mode.

At tp=1 the two engines live in one process and take the SAME parameter
tensors: one set of weights.  ``launch/mesh.disagg_devices`` places them:
two cards when two are visible, else the one card twice.  Under TP the
router would span 2 x tp ranks with the transfer between two rank groups:
not ported yet (``paged_engine.DISAGG_TP_ITEM``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import Config, ServingConfig
from repro_torch.serving.kvcache import OutOfPages, pages_for
from repro_torch.serving.paged_engine import DISAGG_TP_ITEM, PagedEngine
from repro_torch.serving.requests import Request


@dataclass
class RequestRecord:
    """One request's engine-external lifecycle state: what the decode engine
    needs to continue the stream where prefill left it."""
    request: Request
    generated: List[int]              # tokens sampled so far (>= 1 on migrate)
    prompt_len: int                   # effective prompt length
    prefilled: int                    # prompt tokens committed to KV
    chunk_plan: Tuple[int, ...]
    t_submit: float                   # TTFT/TPOT stamps travel with the
    t_first: float                    # request (TTFT is a prefill-side event)
    last_token: int                   # next decode input (not yet in KV)
    draft_table: Optional[Dict[int, int]]   # speculative self-draft state:
    draft_last: int                         # without it spec streams diverge


@dataclass
class PageTransfer:
    """The migration message: lifecycle records and the
    ``KVPool.export_pages`` blob (numpy payloads, export-local page ids).
    Host state only."""
    records: List[RequestRecord]
    blob: Dict[str, Any] = field(repr=False)

    @property
    def n_pages(self) -> int:
        return self.blob["n_pages"]

    @property
    def rids(self) -> List[int]:
        return [r.request.rid for r in self.records]


def _canon(device) -> torch.device:
    """``device`` with the index a tensor made there would report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _params_on(params, device: torch.device):
    """``params`` itself when it already lives on ``device``, else a copy
    there (the decode engine on a second card)."""
    if params["embed"]["table"].device == device:
        return params

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(v) for v in tree)
        return tree.to(device)
    return move(params)


class DisaggRouter:
    """One prefill engine, one decode engine and the migration loop.

    ``prefill_device``/``decode_device`` (default: the card, or where the
    params live) place the engines; on one device both engines use the same
    parameter tensors.  ``prefill_mesh``/``decode_mesh`` (TP groups) raise
    ``NotImplementedError``.  ``cuda_graphs`` is each engine's."""

    # consecutive failed attach retries double the cooldown up to this many
    # router steps: bounded backoff, never preemption
    MAX_BACKOFF_STEPS = 8

    def __init__(self, config: Config, params, *,
                 serving: ServingConfig = None, prefill_mesh=None,
                 decode_mesh=None, prefill_device=None, decode_device=None,
                 cuda_graphs: bool = True):
        if prefill_mesh is not None or decode_mesh is not None:
            raise NotImplementedError(DISAGG_TP_ITEM)
        sv = serving or config.serving
        assert all(k in ("attn_mlp", "attn_moe")
                   for k in config.model.block_pattern), \
            "disagg migrates KV pages only; recurrent per-slot state " \
            "does not transfer"
        self.sv = sv
        dec_sv = sv if not sv.decode_pool_pages else \
            replace(sv, num_pages=sv.decode_pool_pages)
        home = params["embed"]["table"].device
        pdev = _canon(prefill_device) if prefill_device is not None else home
        ddev = _canon(decode_device) if decode_device is not None else pdev
        self.prefill = PagedEngine(config, _params_on(params, pdev),
                                   serving=sv, device=pdev,
                                   cuda_graphs=cuda_graphs, phase="prefill")
        self.decode = PagedEngine(config, _params_on(params, ddev),
                                  serving=dec_sv, device=ddev,
                                  cuda_graphs=cuda_graphs, phase="decode")
        self.migrate_batch = sv.migrate_batch
        self._pending: List[PageTransfer] = []    # detached, attach deferred
        self._cooldown = 0
        self._defers = 0
        self.stats = {"migrations": 0, "migrated_requests": 0,
                      "deferrals": 0, "bounce_backs": 0}

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        """Admit to the prefill engine, after checking that the request can
        ever live in the decode pool too (else it would prefill, then wedge
        the migration queue)."""
        eff = len(req.prompt) + self.prefill._eff_extra(req)
        need = pages_for(eff + req.sampling.max_new_tokens, self.decode.ps)
        if need > self.decode.alloc.num_pages:
            raise ValueError(
                f"request {req.rid}: needs {need} pages but the decode pool "
                f"has {self.decode.alloc.num_pages} (raise "
                f"ServingConfig.decode_pool_pages)")
        return self.prefill.add_request(req)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One router iteration: prefill step -> migrate ready requests ->
        decode step -> bounce eviction victims back.  Returns the merged
        (rid, token) events of both engines."""
        events = self.prefill.step()
        self._retry_pending()
        self._migrate()
        events += self.decode.step()
        self._bounce_back()
        return events

    def done(self) -> bool:
        return (not self._pending
                and not self.prefill.scheduler.waiting
                and all(s is None for s in self.prefill.slots)
                and not self.decode.scheduler.waiting
                and all(s is None for s in self.decode.slots))

    def run_until_complete(self, max_steps: int = 10_000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if self.done():
                break
        return {st.request.rid: st.generated
                for st in self.prefill._finished + self.decode._finished}

    # ------------------------------------------------------------------
    # migration
    # ------------------------------------------------------------------
    def _migrate(self) -> None:
        """Move every decode-ready request the decode pool can host now.

        Candidates (fully prefilled, holding their first sampled token, not
        finished) are taken in the prefill scheduler's policy order, at
        most ``migrate_batch`` a step (0: all).  The prefix that fits the
        decode side's free slots and free pages, less what deferred
        transfers will take, moves; the rest stays on the prefill engine:
        no detach without a home."""
        ready = [s for s in self.prefill.slots
                 if s is not None and not s.done and s.generated
                 and s.prefilled >= sum(s.chunk_plan)]
        if not ready:
            return
        rids = self.prefill.scheduler.order([s.request.rid for s in ready])
        if self.migrate_batch > 0:
            rids = rids[:self.migrate_batch]
        free_slots = sum(1 for s in self.decode.slots if s is None) \
            - sum(len(t.records) for t in self._pending)
        free_pages = self.decode.alloc.free_pages \
            - sum(t.n_pages for t in self._pending)
        take: List[int] = []
        pages: set = set()
        for rid in rids:
            grown = pages | set(self.prefill.alloc.tables[rid])
            if len(take) + 1 > free_slots or len(grown) > free_pages:
                break                 # decode pool full: the rest stays put
            take.append(rid)
            pages = grown
        if not take:
            if rids:
                self.stats["deferrals"] += 1
            return
        transfer = self.prefill.detach_requests(take)
        try:
            self.decode.attach_requests(transfer)
        except OutOfPages:
            # only deferred-transfer retries can race the check above;
            # atomic: queue on the host and retry, never preempt
            self._note_defer()
            self._pending.append(transfer)
            return
        self.stats["migrations"] += 1
        self.stats["migrated_requests"] += len(take)

    def _note_defer(self) -> None:
        self.stats["deferrals"] += 1
        self._defers += 1
        self._cooldown = min(self.MAX_BACKOFF_STEPS, 1 << min(self._defers, 3))

    def _retry_pending(self) -> None:
        """Re-attach deferred transfers, oldest first, under bounded backoff
        (consecutive failures double the cooldown up to MAX_BACKOFF_STEPS
        router steps)."""
        if not self._pending:
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        still: List[PageTransfer] = []
        for t in self._pending:
            if still:                 # keep order: don't leapfrog a stuck one
                still.append(t)
                continue
            free_slots = sum(1 for s in self.decode.slots if s is None)
            if len(t.records) > free_slots:
                still.append(t)
                continue
            try:
                self.decode.attach_requests(t)
                self.stats["migrations"] += 1
                self.stats["migrated_requests"] += len(t.records)
            except OutOfPages:
                still.append(t)
        if still:
            self._note_defer()
        else:
            self._defers = 0
        self._pending = still

    def _bounce_back(self) -> None:
        """Decode-side preemption victims re-enter the PREFILL engine in
        recompute mode: ``_preempt_one`` already freed their pages, reset
        ``prefilled`` and re-planned chunks over prompt + generated, but a
        decode-phase engine never prefills, so the router moves the
        RequestState across and normal admission takes over."""
        while self.decode.scheduler.waiting:
            rid = self.decode.scheduler.pop_waiting()
            st = self.decode._by_rid.pop(rid)
            self.decode.scheduler.forget(rid)
            self.prefill._by_rid[rid] = st
            self.prefill.scheduler.add(rid, priority=st.request.priority)
            self.stats["bounce_backs"] += 1

    # ------------------------------------------------------------------
    def migration_stats(self) -> Dict[str, Any]:
        """Router and both engines' migration counters in one dict."""
        out = dict(self.stats)
        out["migrated_pages"] = self.prefill.metrics["migrated_pages"]
        out["migration_us"] = (self.prefill.metrics["migration_us"]
                               + self.decode.metrics["migration_us"])
        out["pending_transfers"] = len(self._pending)
        return out
