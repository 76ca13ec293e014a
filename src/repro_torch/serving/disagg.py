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
two cards when two are visible, else the one card twice.

Under TP (``mesh=``, a ``launch.mesh.DisaggGroup``) the router spans 2 x
tp rank processes (``launch/mesh.spawn(..., disagg=True)``): the reference
runs both meshes in one program, the port one process a rank.  Each rank
builds only its own engine, on its own parameter shard, over its group's
``TPGroup``; its pool holds its kv-head shard.  Every rank runs ``step()``
in lockstep, in the reference's order, and issues the same world-level
collectives each step:

  1. the prefill ranks run ``prefill.step()``;
  2. deferred transfers are retried: the decode ranks attach, and every
     rank books the outcome the decode ranks report (one exchange, only on
     a step that retries);
  3. the decode ranks report their free slots and pages (exchange C1);
     the leader, prefill rank 0, decides which requests move and
     broadcasts it (C2; every prefill rank checks that its own decision
     is the leader's).  Each prefill rank m detaches those requests and
     sends its ``PageTransfer`` (the same records on every prefill rank,
     its own shard of the pages) to decode rank m, which attaches it;
  4. the decode ranks run ``decode.step()`` and pop their preemption
     victims;
  5. one exchange (C3) gives every rank what each side saw: the attach
     outcome, both sides' events, finished requests and idleness, and the
     victims, which every prefill rank adopts, as ``_bounce_back`` does.

So ``stats``, ``_pending`` (on a prefill rank a transfer without its
pages), the backoff state, ``done()``, ``run_until_complete()``'s tokens,
the events ``step()`` returns and ``migration_stats()`` are the same on
every rank; each exchange checks that the ranks of a group reported the
same thing (the decode ranks of a transfer, the page ids it mapped to), and
a rank that fails a check raises, which brings the spawn down.  An attach
that raises ``OutOfPages`` does so on every decode rank at once: their
allocators hold the same state.

The transfer is one ``dist.send``/``dist.recv`` pair of a byte payload
(its length first) between the two peers over the world group: the
export is host numpy already (``KVPool.export_pages`` copies the pages to
the host), so one pickled buffer costs a host copy and no second process
group, and gloo moves it through host memory whatever the ranks' device.
Under NCCL (2 x tp cards, never run) the bytes go through the rank's card.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ATTN_KINDS, Config, ServingConfig
from repro_torch.launch.mesh import DisaggGroup
from repro_torch.serving.kvcache import OutOfPages, pages_for
from repro_torch.serving.paged_engine import PagedEngine, pool_pages
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
    params live) place the engines at tp=1; on one device both engines use
    the same parameter tensors.  ``mesh`` (a ``launch.mesh.DisaggGroup``)
    runs the router across two TP rank groups, ``params`` then this rank's
    shard (module doc): ``prefill`` or ``decode`` is then None on a rank of
    the other group.  ``cuda_graphs`` is each engine's (TP engines run
    eagerly)."""

    # consecutive failed attach retries double the cooldown up to this many
    # router steps: bounded backoff, never preemption
    MAX_BACKOFF_STEPS = 8

    def __init__(self, config: Config, params, *,
                 serving: ServingConfig = None, mesh: DisaggGroup = None,
                 prefill_device=None, decode_device=None,
                 cuda_graphs: bool = True):
        sv = serving or config.serving
        assert all(k in ATTN_KINDS
                   for k in config.model.block_pattern), \
            "disagg migrates KV pages only; recurrent per-slot state " \
            "does not transfer"
        if mesh is not None and not isinstance(mesh, DisaggGroup):
            raise TypeError(f"mesh must be a launch.mesh.DisaggGroup, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and (prefill_device is not None
                                 or decode_device is not None):
            raise ValueError("under a DisaggGroup each rank's device is its "
                             "group's")
        self.sv = sv
        dec_sv = sv if not sv.decode_pool_pages else \
            replace(sv, num_pages=sv.decode_pool_pages)
        self.mesh = mesh
        self.prefill: Optional[PagedEngine] = None
        self.decode: Optional[PagedEngine] = None
        if mesh is None:
            home = params["embed"]["table"].device
            pdev = _canon(prefill_device) if prefill_device is not None \
                else home
            ddev = _canon(decode_device) if decode_device is not None \
                else pdev
            self.prefill = PagedEngine(config, _params_on(params, pdev),
                                       serving=sv, device=pdev,
                                       cuda_graphs=cuda_graphs,
                                       phase="prefill")
            self.decode = PagedEngine(config, _params_on(params, ddev),
                                      serving=dec_sv, device=ddev,
                                      cuda_graphs=cuda_graphs, phase="decode")
        elif mesh.role == "prefill":
            self.prefill = PagedEngine(config, params, serving=sv,
                                       mesh=mesh.tp_group,
                                       cuda_graphs=cuda_graphs,
                                       phase="prefill")
        else:
            self.decode = PagedEngine(config, params, serving=dec_sv,
                                      mesh=mesh.tp_group,
                                      cuda_graphs=cuda_graphs, phase="decode")
        # the decode pool's size and page, known on every rank
        self._decode_pages = pool_pages(dec_sv)
        self._decode_ps = dec_sv.page_size
        self.migrate_batch = sv.migrate_batch
        self._pending: List[PageTransfer] = []    # detached, attach deferred
        self._cooldown = 0
        self._defers = 0
        self.stats = {"migrations": 0, "migrated_requests": 0,
                      "deferrals": 0, "bounce_backs": 0}
        # what each side last reported (exchange C3): both engines idle,
        # the tokens of every finished request, and the engines' migration
        # counters
        self._done = True
        self._outputs: Dict[int, List[int]] = {}
        self._reported = [0, 0]               # finished states reported
        self._side_metrics = {"migrated_pages": 0, "prefill_us": 0.0,
                              "decode_us": 0.0}
        self._steps = 0
        # this rank's side of the page transfers: count, bytes sent or
        # received (0 at tp=1) and host seconds from the broadcast decision
        # to the end of the rank's part (prefill: export and send; decode:
        # the receive, which waits for the peer's export, and the import)
        self.wire = {"transfers": 0, "bytes": 0, "s": 0.0}

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        """Admit to the prefill engine, after checking that the request can
        ever live in the decode pool too (else it would prefill, then wedge
        the migration queue).  Under TP every rank submits the same
        requests; only the prefill ranks hold them."""
        eff = len(req.prompt) + PagedEngine._eff_extra(req)
        need = pages_for(eff + req.sampling.max_new_tokens, self._decode_ps)
        if need > self._decode_pages:
            raise ValueError(
                f"request {req.rid}: needs {need} pages but the decode pool "
                f"has {self._decode_pages} (raise "
                f"ServingConfig.decode_pool_pages)")
        self._done = False
        if self.prefill is None:
            return req.rid
        return self.prefill.add_request(req)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One router iteration: prefill step -> retry deferred transfers
        -> migrate ready requests -> decode step -> bounce eviction victims
        back.  Returns the merged (rid, token) events of both engines (the
        same on every rank)."""
        self._steps += 1
        p_events = self.prefill.step() if self.prefill is not None else []
        self._retry_pending()
        moved = self._migrate()
        d_events = self.decode.step() if self.decode is not None else []
        return self._settle(p_events, d_events, moved)

    def done(self) -> bool:
        """No request waiting, resident or in a deferred transfer on either
        engine, as of the last ``step()`` (the same on every rank)."""
        return self._done

    def run_until_complete(self, max_steps: int = 10_000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if self.done():
                break
        return self.outputs()

    def outputs(self) -> Dict[int, List[int]]:
        """rid -> generated tokens of every request either engine finished
        (the same on every rank)."""
        return dict(self._outputs)

    # ------------------------------------------------------------------
    # migration
    # ------------------------------------------------------------------
    def _migrate(self) -> Optional[tuple]:
        """Move every decode-ready request the decode pool can host now.

        Candidates (fully prefilled, holding their first sampled token, not
        finished) are taken in the prefill scheduler's policy order, at
        most ``migrate_batch`` a step (0: all).  The prefix that fits the
        decode side's free slots and free pages, less what deferred
        transfers will take, moves; the rest stays on the prefill engine:
        no detach without a home.  Returns None when nothing moved, else
        (this rank's transfer, whether the attach took it, the page tables
        it installed); on a prefill rank under TP the last two are None,
        and ``_settle`` learns them."""
        room = None
        if self.decode is not None:
            room = (sum(1 for s in self.decode.slots if s is None),
                    self.decode.alloc.free_pages)
        room = self._from_decode(room)
        plan = self._plan(*room) if self.prefill is not None else None
        take, wanted = self._from_leader(plan)
        if not take:
            if wanted:
                self.stats["deferrals"] += 1
            return None
        t0 = time.perf_counter()
        transfer = self.prefill.detach_requests(take) \
            if self.prefill is not None else None
        transfer = self._hand_over(transfer)
        # OutOfPages can only race the plan through deferred-transfer
        # retries; atomic: the transfer then queues on the host
        ok = tables = None
        if self.decode is not None:
            ok = self._attach(transfer)
            # the page ids the import mapped to, which every decode rank
            # must agree on
            tables = {rid: list(self.decode.alloc.tables[rid])
                      for rid in transfer.rids} if ok else {}
        self.wire["transfers"] += 1
        self.wire["s"] += time.perf_counter() - t0
        return transfer, ok, tables

    def _plan(self, free_slots: int, free_pages: int
              ) -> Tuple[List[int], bool]:
        """The leader's decision: (rids to move, whether any was ready)."""
        ready = [s for s in self.prefill.slots
                 if s is not None and not s.done and s.generated
                 and s.prefilled >= sum(s.chunk_plan)]
        if not ready:
            return [], False
        rids = self.prefill.scheduler.order([s.request.rid for s in ready])
        if self.migrate_batch > 0:
            rids = rids[:self.migrate_batch]
        free_slots -= sum(len(t.records) for t in self._pending)
        free_pages -= sum(t.n_pages for t in self._pending)
        take: List[int] = []
        pages: set = set()
        for rid in rids:
            grown = pages | set(self.prefill.alloc.tables[rid])
            if len(take) + 1 > free_slots or len(grown) > free_pages:
                break                 # decode pool full: the rest stays put
            take.append(rid)
            pages = grown
        return take, bool(rids)

    def _attach(self, transfer: "PageTransfer") -> bool:
        try:
            self.decode.attach_requests(transfer)
        except OutOfPages:
            return False
        return True

    def _note_defer(self) -> None:
        self.stats["deferrals"] += 1
        self._defers += 1
        self._cooldown = min(self.MAX_BACKOFF_STEPS, 1 << min(self._defers, 3))

    def _retry_pending(self) -> None:
        """Re-attach deferred transfers, oldest first, under bounded backoff
        (consecutive failures double the cooldown up to MAX_BACKOFF_STEPS
        router steps).  The decode side attaches; every rank books what it
        reports."""
        if not self._pending:
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        attached = None
        if self.decode is not None:
            attached = []
            for t in self._pending:
                # keep order: don't leapfrog a stuck one
                free_slots = sum(1 for s in self.decode.slots if s is None)
                attached.append(
                    (not attached or attached[-1])
                    and len(t.records) <= free_slots and self._attach(t))
        attached = self._from_decode(attached)
        still: List[PageTransfer] = []
        for t, ok in zip(self._pending, attached):
            if ok:
                self.stats["migrations"] += 1
                self.stats["migrated_requests"] += len(t.records)
            else:
                still.append(t)
        if still:
            self._note_defer()
        else:
            self._defers = 0
        self._pending = still

    def _settle(self, p_events, d_events, moved) -> List[Tuple[int, int]]:
        """Share what each side saw this step (exchange C3) and book it on
        every rank: the migration's attach outcome, the decode-side
        preemption victims bouncing back to the PREFILL engine in
        recompute mode (``_preempt_one`` already freed their pages, reset
        ``prefilled`` and re-planned chunks over prompt + generated, but a
        decode-phase engine never prefills, so the router moves the
        ``RequestState`` across and normal admission takes over), finished
        requests, idleness and the migration counters."""
        p_rep = d_rep = None
        if self.prefill is not None:
            eng = self.prefill
            p_rep = dict(check=dict(
                step=self._steps, events=p_events,
                finished=self._finished_since(eng, 0), idle=_idle(eng),
                pages=eng.metrics["migrated_pages"]),
                us=eng.metrics["migration_us"])
        if self.decode is not None:
            eng = self.decode
            victims = []
            while eng.scheduler.waiting:
                rid = eng.scheduler.pop_waiting()
                victims.append(eng._by_rid.pop(rid))
                eng.scheduler.forget(rid)
            d_rep = dict(check=dict(
                step=self._steps, events=d_events,
                finished=self._finished_since(eng, 1), idle=_idle(eng),
                attached=None if moved is None else moved[1:],
                victims=[st.request.rid for st in victims]),
                victims=victims, us=eng.metrics["migration_us"])
        p_rep, d_rep = self._exchange_sides(p_rep, d_rep)
        pc, dc = p_rep["check"], d_rep["check"]
        if moved is not None:
            transfer = moved[0]
            if dc["attached"][0]:
                self.stats["migrations"] += 1
                self.stats["migrated_requests"] += len(transfer.records)
            else:
                self._note_defer()
                self._pending.append(transfer)
        for st in d_rep["victims"]:
            if self.prefill is not None:
                self.prefill._by_rid[st.request.rid] = st
                self.prefill.scheduler.add(st.request.rid,
                                           priority=st.request.priority)
            self.stats["bounce_backs"] += 1
        self._outputs.update(pc["finished"])
        self._outputs.update(dc["finished"])
        self._done = not self._pending and pc["idle"] and dc["idle"]
        self._side_metrics = {"migrated_pages": pc["pages"],
                              "prefill_us": p_rep["us"],
                              "decode_us": d_rep["us"]}
        return pc["events"] + dc["events"]

    def _finished_since(self, eng: PagedEngine, i: int) -> Dict[int, list]:
        """Tokens of the requests ``eng`` finished since the last report."""
        new = eng._finished[self._reported[i]:]
        self._reported[i] = len(eng._finished)
        return {st.request.rid: st.generated for st in new}

    # ------------------------------------------------------------------
    # exchanges between the rank groups (identities at tp=1)
    # ------------------------------------------------------------------
    def _gather(self, mine) -> list:
        """Every rank's ``mine``, in global rank order."""
        out = [None] * (2 * self.mesh.tp)
        dist.all_gather_object(out, mine, group=self.mesh.world)
        return out

    def _exchange_sides(self, p_rep, d_rep) -> tuple:
        """(prefill report, decode report) on every rank: group rank 0's,
        after checking that every rank of each group sent the same
        ``check`` (the whole report if it has none)."""
        if self.mesh is None:
            return p_rep, d_rep
        reps = self._gather(p_rep if self.prefill is not None else d_rep)
        tp = self.mesh.tp
        for role, side in (("prefill", reps[:tp]), ("decode", reps[tp:])):
            key = [r["check"] if isinstance(r, dict) and "check" in r
                   else r for r in side]
            if any(k != key[0] for k in key[1:]):
                raise AssertionError(f"disagg: the {role} ranks disagree at "
                                     f"router step {self._steps}: {key}")
        return reps[0], reps[tp]

    def _from_decode(self, value):
        """The decode side's ``value`` on every rank."""
        return self._exchange_sides(None, value)[1]

    def _from_leader(self, plan):
        """The leader's (prefill rank 0's) ``plan`` on every rank; every
        prefill rank checks that it took the same decision."""
        if self.mesh is None:
            return plan
        box = [plan]
        dist.broadcast_object_list(box, src=0, group=self.mesh.world)
        if self.prefill is not None and box[0] != plan:
            raise AssertionError(f"disagg: prefill rank "
                                 f"{self.mesh.tp_group.rank} planned {plan}, "
                                 f"the leader {box[0]}")
        return box[0]

    def _hand_over(self, transfer: Optional["PageTransfer"]
                   ) -> "PageTransfer":
        """Move a detached transfer from each prefill rank to its peer
        decode rank: the peer's copy comes back on a decode rank, the
        transfer without its pages on a prefill rank (what ``_pending``
        keeps there).  The identity at tp=1."""
        if self.mesh is None:
            return transfer
        wire = self.mesh.device if self.mesh.backend == "nccl" \
            else torch.device("cpu")
        peer = self.mesh.peer
        if self.prefill is not None:
            data = pickle.dumps(transfer, protocol=pickle.HIGHEST_PROTOCOL)
            dist.send(torch.tensor([len(data)], dtype=torch.int64,
                                   device=wire), dst=peer)
            dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8)
                      .to(wire), dst=peer)
            out = PageTransfer(records=transfer.records, blob={
                k: v for k, v in transfer.blob.items() if k != "pages"})
        else:
            n = torch.zeros(1, dtype=torch.int64, device=wire)
            dist.recv(n, src=peer)
            buf = torch.empty(int(n), dtype=torch.uint8, device=wire)
            dist.recv(buf, src=peer)
            data = buf.cpu().numpy()
            out = pickle.loads(memoryview(data))
        self.wire["bytes"] += len(data)
        return out

    # ------------------------------------------------------------------
    def migration_stats(self) -> Dict[str, Any]:
        """Router and both engines' migration counters in one dict, as of
        the last ``step()`` (the same on every rank: each engine's counters
        are its group rank 0's)."""
        out = dict(self.stats)
        out["migrated_pages"] = self._side_metrics["migrated_pages"]
        out["migration_us"] = (self._side_metrics["prefill_us"]
                               + self._side_metrics["decode_us"])
        out["pending_transfers"] = len(self._pending)
        return out


def _idle(eng: PagedEngine) -> bool:
    return not eng.scheduler.waiting and all(s is None for s in eng.slots)
