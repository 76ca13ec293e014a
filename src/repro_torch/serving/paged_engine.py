"""Paged continuous-batching engine: chunked prefill interleaved with decode
(port of ``repro/serving/paged_engine.py`` with its compiled closures).

KV memory is a shared page pool (serving/kvcache.py).  Each ``step()``:

  * admits waiting requests into free slots;
  * runs this step's token-budget slice of prefill grants, each padded up to
    a bucket length (``core/chunking.grant_buckets``) with the pad tail
    masked out of attention and routed to the scratch page.  With
    ``prefill_batching`` (the default) grants of one padded length are
    PACKED into one forward call (``scheduler.pack_grants``), the row count
    padded up to a power-of-two row bucket; every row carries its own
    start (doubling as its paged ``prefix_len``: a fresh row is a row with
    prefix 0) and real length, and pad rows have n_real 0, an empty block
    table and write only to the scratch page.  A pack whose rows are all
    fresh takes the dense intra-call path, with no block-table walk; any
    other reads its rows' page-resident prefixes in place through the paged
    flash-prefill kernel.  Without it each grant is its own batch-1 call,
    fresh or resumed.  Inside each call the ISO chunk order of
    ``core/iso.run_layer`` applies;
  * runs ONE batched decode step over all slots whose prompt is resident,
    reading the pools in place through the paged flash-decode kernel, split
    into S spans by ``_kv_splits``, and scattering the window's KV into its
    pages in place.  With ``spec_k > 0`` the window is a (spec_k+1)-token
    verify of each slot's self-drafted tokens (``serving/speculative.py``)
    whenever every decoding request is greedy, drafted, fits under
    ``max_len`` and the window's pages fit without eviction; only the
    accepted tokens are committed.

Prefix sharing (``prefix_sharing``, the default): at admission, and again
when a fresh grant is prepared, a request maps the pages of a live donor's
matching prompt prefix into its own table (``PrefixCache``,
``PageAllocator.adopt``; refcounted, nothing copied) and prefills from the
shared length on.  Before any write into a shared page the writer gets its
own copy (``PageAllocator.cow`` and ``_copy_page``, which may evict for the
copy target).  A fresh grant whose first page matches an earlier member of
its pack is deferred to a follow-up pack, so it shares the tokens its
packmate commits, as the batch-1 path would.  The port has no ``pos`` pool
to roll back or scrub (serving/kvcache.py): KV past a request's length,
from rejected verify positions or a donor's tail on an adopted page, is
masked by the resident lengths the kernels take.

Observability, as in the reference (``src/repro_torch/obs``): ``registry``
is an always-on ``MetricsRegistry`` and ``metrics`` its dict view over the
reference's whole counter set (``prefill_calls``: forward calls, packs or
batch-1 grants; ``spec_calls``: decode steps that verified a window;
``migrations``, ``migrated_pages`` and ``migration_us``: page transfers), with
the ``tpot`` and ``accept_len`` histograms.  ``trace``
is a bounded ``TraceRing`` the scheduler, the allocator and every phase of
the host loop narrate into at the reference's points with its payloads
(admit, grant, pack, defer, grant_commit, prefill_call, sample,
decode_call, accept, spec_rollback, evict, finish, pool, decision, the
allocator's alloc/free/cow/adopt/rc_drop, and detach, attach and migrate
of a page transfer); ``observability=False``
silences the ring and leaves the registry.  Every emit and every
histogram observation runs on the host between closure calls, never in a
captured body.

Phase spans (``obs.torchprof.Span``, ``STEP_SPANS``) tile each ``step()``:
``engine/schedule`` (admission, grants and packs, sharing, page growth,
copy-on-write, the host arrays and block tables, the split count and the
closure lookup, the pool's narration; counter ``prep_s``),
``engine/capture`` (a graph's capture; ``capture_s``),
``engine/prefill.launch`` and ``engine/decode.launch`` (staging, replay,
the logits' gather and the greedy pick until the calls return;
``prefill_dispatch_s``, ``decode_dispatch_s``), ``engine/prefill.wait``
and ``engine/decode.wait`` (the fence; with the launch, ``prefill_s`` and
``decode_s``), ``engine/logits.to_host`` (the rows' greedy ids, and the
logits of rows that sample on the host; ``logits_copy_s``) and
``engine/sample`` (commit, sampling or greedy accept, retiring;
``sample_s``).  One is open at
a time, so their seconds add up to the step's host time ``step_s``.  Their
counters are always on; while any ``torch.profiler`` records, each also
puts a range of its name on the profile, so the card's idle gaps can be put
down to them.  Inside a launch span each closure call runs under
``obs.torchprof.annotate`` with the reference's names (``prefill/T=…``,
``prefill/T=…x…``, ``decode/K=…/S=…``).  ``grant_wait_s`` over
``grant_wait_n``: the time from a request's submission, or its recompute
preemption, to the start of its first prefill call after it.

Measured cost model (``perf/costmodel.py``): ``ServingConfig.cost_model``,
or a table loaded from ``cost_table`` (``"auto"``: the bundled
``perf/tables/<platform>_tp<tp>.json``, the platform from
``device.platform_name``; a failed load emits one ``warning`` and serves on
the static defaults).  With one, the split count S (``_kv_splits``), the
spec gate (``_spec_window``), the grant cap and the pack width
(scheduler) come from its measurements, each logged as a ``decision``.

Compiled closures.  As the reference jits one closure per key, the port
builds one ``StepClosure`` per key (serving/closures.py, shared with the
dense-cache ``Engine``): static input buffers of the key's shape and the
step's body over them.  Prefill keys are (bucket, fresh|resumed)
batch-1, or (bucket, row bucket, all-fresh) packed; decode keys are (K, S);
the page copy of copy-on-write is one closure for any (old, new) pair.  A
step copies its host arrays into the buffers and calls the closure.  On the
card at tp=1 the body is captured once per key in a ``torch.cuda.CUDAGraph``
(every graph drawing on one shared memory pool) and each call is one
replay, the counterpart of calling a ``jax.jit`` executable;
``cuda_graphs=False`` runs the same bodies eagerly, as ``jax.disable_jit()``
would.  Every host decision (the key: rows, all-fresh, K) picks a closure;
every per-row value is a device buffer.  A failed capture or replay raises;
nothing gives way to the eager path, to batch-1 or to K=1.  On the CPU, and
in a TP engine, the bodies run eagerly over the same buffers: a TP engine's
collectives go through gloo on the host, which a graph cannot hold, and
capturing NCCL collectives waits on ROADMAP queue A item 7.

Tensor parallelism: ``mesh=`` takes this rank's ``launch.mesh.TPGroup``
(of a mixed engine, or of a prefill or decode group of disaggregated
serving); ``params`` are then the rank's shard (``bridge.shard_params`` or
``api.init_params(..., rank=)``) and the pool holds its share of the kv
heads.  Every rank runs this same host loop on the same requests, so every
rank takes the same decisions; the vocab-sharded logits are gathered before
sampling, so every rank samples the same token.  The decode collective
schedule follows the reference: ``auto`` is ``batch_split`` under TP when
``decode_overlap`` and ``max_batch >= 2`` (``sequential`` otherwise), with
a sequential step whenever fewer than 2 requests decode; ``sequential``,
``batch_split`` and ``cross_block`` can be forced.  A ladder-wired config
(``residual_wiring="ladder"``) always runs the ladder decode stack: deferred
collectives (``ladder``) when ``decode_overlap``, immediate ones
(``ladder_seq``) otherwise, or the one ``decode_schedule`` names.

Sampling: right after each call that samples, still inside its launch
span, every row's greedy token is picked on the device (``pick_greedy``, the
argmax over the vocab's columns of the gathered logits) and only those
(B, K) ids are copied to the host after the fence.  A row whose
``SamplingParams`` has ``temperature > 0`` (never inside a verify window)
has its logits row selected on the device and copied, and samples on the
host (``serving/sampler.sample``) as the reference does; a call with no
such row copies no logits.  ``sampled_rows_device`` and
``sampled_rows_host`` count the rows each way.

When the pool runs dry a victim is evicted (recompute preemption: its pages
are freed and prompt + generated re-enter the waiting queue).

A VLM request (``Request.patches``, (n, d_model)) occupies n positions
ahead of its text: its prompt is one chunk, granted whole and never
padded, packed or shared (a patch-carrying model's engine has no buckets
and no packing at all, as the reference's).  Its first grant carries the
patches; a later grant (the tail a grant cap cut off) is text from the
text offset ``start - n``.

Disaggregated serving (``serving/disagg.py``): ``phase="prefill"`` admits
and prefills only (a request's first token comes from its prefill's last
logits), ``phase="decode"`` decodes only, its requests arriving by
``attach_requests``; ``detach_requests`` exports requests with their pages
(``kv_pool``: the engine-external ``KVPool``).  Detach and attach run
between steps, never inside a capture or a replay: an attach writes the
pages in place and sets the host ``lengths``/``last_tokens`` that the next
decode step stages into its static buffers.  Under TP a phase engine
runs on its rank group's ``TPGroup`` like a mixed one: its pool holds this
rank's kv-head shard, so ``detach_requests`` exports that shard and
``attach_requests`` imports it; every rank of a group holds the same host
state (scheduler, allocator, slots, and the page ids an import maps to),
and the router moves the shards between peer ranks of the two groups.
``measure_overlap_efficiency`` times the decode collective schedules
against each other (``obs/overlap_probe.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ATTN_KINDS, MOE_KINDS, Config, \
    ServingConfig, SigmoidMoEConfig, padded_vocab
from repro_torch.core.chunking import grant_buckets, round_to_bucket
from repro_torch.core.iso import DECODE_SCHEDULES
from repro_torch.core.overlap import AxisCtx, all_gather_last
from repro_torch.device import platform_name, resolve_device, synchronize
from repro_torch.launch.mesh import TPGroup
from repro_torch.layers import embeddings as emb_lib
from repro_torch.models import api
from repro_torch.models.decoder import check_supported
from repro_torch.obs import torchprof
from repro_torch.obs.registry import ACCEPT_LEN_BUCKETS, MetricsRegistry, \
    TPOT_BUCKETS_S
from repro_torch.obs.trace import TraceRing
from repro_torch.perf.costmodel import load_cost_model
from repro_torch.serving.kvcache import OutOfPages, PrefixCache, pages_for, \
    token_page_coords, window_page_coords
from repro_torch.serving.closures import StepClosure
from repro_torch.serving.kvstate import KVPool
from repro_torch.serving.requests import Request, RequestState
from repro_torch.serving.sampler import sample
from repro_torch.serving.scheduler import PrefillGrant, \
    TokenBudgetScheduler, plan_chunks
from repro_torch.serving.speculative import BigramDraft, accept_greedy


# the phase spans that tile ``step()``: (name, the counters each adds its
# host seconds to); the profiler range of each is ``engine/<name>``
STEP_SPANS = (
    ("schedule", ("prep_s",)),
    ("capture", ()),                  # its seconds: the captures' capture_s
    ("prefill.launch", ("prefill_dispatch_s", "prefill_s")),
    ("prefill.wait", ("prefill_s",)),
    ("decode.launch", ("decode_dispatch_s", "decode_s")),
    ("decode.wait", ("decode_s",)),
    ("logits.to_host", ("logits_copy_s",)),
    ("sample", ("sample_s",)),
)


def pick_greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The greedy token of every row of gathered logits (..., V_pad): the
    argmax over the first ``vocab`` columns (a padded column never wins) in
    the logits' own dtype, the first of equal maxima as ``np.argmax`` takes
    it; int32 on the logits' device."""
    return logits[..., :vocab].argmax(-1).to(torch.int32)


def _on_host(sampling) -> bool:
    """Whether a row with these ``SamplingParams`` samples on the host."""
    return sampling.temperature > 0


# the paged engine serves decoder-only stacks, as the reference's
AUDIO_MSG = ("encoder-decoder (audio) models are served by the dense Engine "
             "(serving/engine.py), not the paged one")


def pool_pages(sv: ServingConfig) -> int:
    """Pages in the pool of an engine serving with ``sv``: ``num_pages``,
    else enough for ``max_batch`` requests of ``max_len``."""
    return sv.num_pages or sv.max_batch * -(-sv.max_len // sv.page_size)


def _decode_schedule_for(cfg, sv: ServingConfig, tp_mesh: bool) -> str:
    """The engine's decode collective schedule, as the reference picks it:
    a ladder-wired config always runs the ladder decode stack, deferred
    (``ladder``) when ``decode_overlap`` and immediate (``ladder_seq``)
    otherwise, unless ``decode_schedule`` names one of the two; a
    standard-wired one runs ``decode_schedule``, where ``auto`` is
    ``batch_split`` under TP with ``decode_overlap`` and ``max_batch >= 2``
    and ``sequential`` otherwise.  A ladder schedule on a standard-wired
    config would serve the rewired function, and raises."""
    if sv.decode_schedule not in ("auto",) + DECODE_SCHEDULES:
        raise ValueError(f"decode_schedule={sv.decode_schedule!r}: one of "
                         f"auto, {', '.join(DECODE_SCHEDULES)}")
    ladder = sv.decode_schedule in ("ladder", "ladder_seq")
    if cfg.residual_wiring == "ladder":
        if ladder:
            return sv.decode_schedule
        return "ladder" if sv.decode_overlap else "ladder_seq"
    if ladder:
        raise ValueError(f"decode_schedule={sv.decode_schedule!r} on the "
                         f"standard-wired {cfg.name}: the ladder schedules "
                         f"serve a ladder-wired arch (configs.LADDER)")
    if sv.decode_schedule == "auto":
        return "batch_split" if (tp_mesh and sv.decode_overlap
                                 and sv.max_batch >= 2) else "sequential"
    return sv.decode_schedule


class PagedEngine:
    """``cuda_graphs`` (default True) captures each step closure in a CUDA
    graph on the card at tp=1; False runs the closures eagerly (A/B runs,
    the eager-vs-graphed check).  CPU and TP engines always run them
    eagerly (module doc).  ``phase`` (``mixed``, ``prefill`` or
    ``decode``) and ``kv_pool`` (an engine-external ``KVPool``) serve
    disaggregation (``serving/disagg.py``)."""

    def __init__(self, config: Config, params, *,
                 serving: ServingConfig = None, mesh: TPGroup = None,
                 device=None, cuda_graphs: bool = True, phase: str = "mixed",
                 kv_pool: KVPool = None):
        if phase not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown engine phase {phase!r}")
        if mesh is not None and not isinstance(mesh, TPGroup):
            raise TypeError(f"mesh must be a launch.mesh.TPGroup, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the TP group's "
                             f"{mesh.device}")
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        sv = serving or config.serving
        check_supported(config.model)
        if config.model.family == "audio":
            raise NotImplementedError(AUDIO_MSG)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}; make them with "
                             f"api.init_params(..., device=...)")
        self.config = config
        self.cfg = config.model
        self.params = params
        self.sv = sv
        self.ps = sv.page_size
        self.max_batch = sv.max_batch
        self.max_len = sv.max_len
        self.max_blocks = -(-sv.max_len // sv.page_size)
        num_pages = pool_pages(sv)
        if mesh is not None:
            if config.parallel.model != mesh.tp:
                raise ValueError(f"ParallelConfig.model="
                                 f"{config.parallel.model} but the TP group "
                                 f"has {mesh.tp} ranks")
            self.tp = mesh.tp
            self._ctx = mesh.axis_ctx(config.iso.quantized_comm)
        else:
            self.tp = 1
            self._ctx = AxisCtx()
        if table.shape[0] * self.tp != padded_vocab(self.cfg, self.tp):
            raise ValueError(f"embedding shard of {table.shape[0]} rows is "
                             f"not 1/{self.tp} of the tp={self.tp} padded "
                             f"vocab; pass this rank's shard of params built "
                             f"at tp={self.tp}")
        self._decode_schedule = _decode_schedule_for(self.cfg, sv,
                                                    mesh is not None)
        # decode steps run per schedule (batch_split falls back to
        # sequential on steps with fewer than 2 decoding requests)
        self.decode_schedule_steps: Dict[str, int] = {}
        # observability: the registry is always on (host-side counter
        # bumps); ``observability=False`` silences the trace ring
        self.registry = MetricsRegistry()
        self.trace = TraceRing(capacity=sv.trace_events,
                               enabled=sv.observability)
        self.registry.histogram("tpot", TPOT_BUCKETS_S)
        self.registry.histogram("accept_len", ACCEPT_LEN_BUCKETS)
        # measured cost model: an injected CostModel, or one loaded from
        # ``cost_table`` ("" off, "auto" the bundled per-platform table,
        # else a path); a failed load emits one warning and leaves None, so
        # every decision takes the static path
        self.cost_model = sv.cost_model
        if self.cost_model is None and sv.cost_table:
            self.cost_model = load_cost_model(
                sv.cost_table, platform=platform_name(self.device),
                tp=self.tp, trace=self.trace)
        # KV ownership lives outside the engine (serving/kvstate.KVPool), so
        # pages can move between engines; an injected pool narrates into
        # this engine's ring, keeping the replay oracle per engine
        if kv_pool is None:
            kv_pool = KVPool.create(self.cfg, num_pages, self.ps, tp=self.tp,
                                    dtype=table.dtype, device=self.device,
                                    trace=self.trace)
        else:
            if kv_pool.page_size != self.ps or kv_pool.dtype != table.dtype \
                    or kv_pool.kv.device.type != self.device.type:
                raise ValueError(
                    f"kv_pool (page {kv_pool.page_size}, {kv_pool.dtype}, "
                    f"{kv_pool.kv.device}) does not fit this engine "
                    f"(page {self.ps}, {table.dtype}, {self.device})")
            kv_pool.alloc.trace = self.trace
        self.pool = kv_pool
        self.alloc = kv_pool.alloc
        self.kv = kv_pool.kv
        # phase routing (disagg): "prefill" never runs the decode phase,
        # "decode" never admits or prefills; "mixed" is the single engine
        self.phase = phase
        # per-slot recurrent states (hybrid, mlstm, slstm positions), this
        # rank's shard, static buffers every closure reads and advances in
        # place: a fresh grant starts from zero state and writes its slot's,
        # a resumed one reads and writes it, decode advances the slots that
        # decode
        self.states = api.init_state_caches(self.cfg, sv.max_batch, self.tp,
                                            dtype=table.dtype,
                                            device=self.device, local=True)
        self._state_tensors = tuple(t for c in self.states
                                    for st in c.values() for t in st)
        # the reference's gates: bucketing, packing, prefix sharing and
        # speculation only for attention-only stacks (pad tokens, packed
        # rows, shared pages and rejected verify tokens would each advance a
        # recurrent state wrongly); a recurrent stack runs one closure per
        # exact grant length
        attn_only = all(k in ATTN_KINDS for k in self.cfg.block_pattern)
        # nor for a patch-carrying model: its patch grants run unbucketed
        # and unpacked (a row-heterogeneous embed layout)
        no_patches = self.cfg.num_patches == 0
        self._buckets = grant_buckets(sv.max_len, sv.min_grant_bucket,
                                      sv.grant_buckets) \
            if sv.grant_bucketing and attn_only and no_patches else None
        self.scheduler = TokenBudgetScheduler(
            policy=sv.scheduler_policy,
            prefill_token_budget=sv.prefill_token_budget,
            grant_buckets=self._buckets, trace=self.trace,
            cost_model=self.cost_model, phase=phase)
        # batched prefill: same-padded-length grants packed into one call,
        # the row count padded up a power-of-two ladder so closures stay
        # keyed on (length bucket, row bucket, all-fresh)
        self._batch_prefill = sv.prefill_batching and attn_only \
            and no_patches
        self._row_buckets = grant_buckets(sv.max_batch, min_bucket=1) \
            if self._batch_prefill else (1,)
        # copy-on-write prefix sharing
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache(self.ps) if sv.prefix_sharing and attn_only else None
        # speculative decoding: greedy-only self-drafting
        self.spec_k = sv.spec_k if attn_only else 0
        self._drafts: List[Optional[BigramDraft]] = [None] * sv.max_batch
        self.slots: List[Optional[RequestState]] = [None] * sv.max_batch
        self.lengths = np.zeros(sv.max_batch, np.int64)   # tokens resident
        self.last_tokens = np.zeros(sv.max_batch, np.int64)
        self._by_rid: Dict[int, RequestState] = {}        # waiting + running
        self._finished: List[RequestState] = []
        # the reference's counter set, pre-registered so ``metrics[k] == 0``
        # holds before first use; timed sums are fenced execution time, the
        # *_dispatch_s pair the host time until the calls return.  The port
        # adds the step's host time by phase (STEP_SPANS: step_s, prep_s,
        # logits_copy_s, sample_s), the wait before a request's first
        # prefill call (grant_wait_s over grant_wait_n) and the sampled rows
        # whose token was picked on the device or on the host
        self.registry.counters((
            "step_s", "prep_s", "logits_copy_s", "sample_s", "grant_wait_s",
            "grant_wait_n", "sampled_rows_device", "sampled_rows_host",
            "prefill_s", "decode_s", "prefill_dispatch_s",
            "decode_dispatch_s", "prefill_tokens", "decode_tokens",
            "completed", "decode_calls", "prefill_calls", "steps",
            "preemptions", "ttft_sum", "ttft_n", "prefix_shared_tokens",
            "cow_copies", "peak_used_pages", "prefill_pad_tokens",
            "prefill_samples", "spec_calls", "spec_tokens", "prefill_grants",
            "resumed_grants", "prefill_pad_rows", "migrations",
            "migrated_pages", "migration_us"))
        # a dropless MoE stack's layer counters: MoE layer calls and the
        # rows they took (pads included), counted on the host, and the
        # local experts the calls reached, summed on the device into
        # ``moe_hits`` inside the closures (graphs included) and read into
        # ``moe_experts_hit`` only by ``read_moe_hits``, off the step path
        self._moe_layers = sum(
            1 for layer in range(self.cfg.num_layers)
            if self.cfg.block_kind(layer) in MOE_KINDS) \
            if isinstance(self.cfg.moe, SigmoidMoEConfig) else 0
        self.moe_hits = torch.zeros((), dtype=torch.int64,
                                    device=self.device) \
            if self._moe_layers else None
        if self._moe_layers:
            self.registry.counters(("moe_calls", "moe_rows",
                                    "moe_experts_hit"))
        # what a closure body advances in place, put back after a capture's
        # warm-up
        self._mutated = self._state_tensors + (
            (self.moe_hits,) if self._moe_layers else ())
        self.metrics = self.registry.view()
        # the step's phase spans (obs/torchprof.Span) on one tile: one is
        # open at a time, so their counters add up to the step
        tile = [None]
        self._spans = {
            name: torchprof.Span(f"engine/{name}",
                                 *map(self.registry.counter, keys),
                                 tile=tile)
            for name, keys in STEP_SPANS}
        # decode steps run per split count S
        self.decode_splits: Dict[int, int] = {}
        # compiled closures, keyed as the reference's jit caches: prefill
        # (bucket, resumed) batch-1 or (bucket, rows, all_fresh) packed;
        # decode (K, S); the batch-split engine's sequential fallback (K, S)
        # apart, so the decode keys stay schedule-pure; one page copy
        self._prefill_fns: Dict[Tuple, StepClosure] = {}
        self._decode_fns: Dict[Tuple[int, int], StepClosure] = {}
        self._decode_fallback_fns: Dict[Tuple[int, int], StepClosure] = {}
        # overlap-probe closures (schedule, comm), apart from _decode_fns,
        # whose key set is real traffic's; their captures are not counted
        # in ``graphs``
        self._probe_decode_fns: Dict[Tuple[str, bool], StepClosure] = {}
        self._copy_page_fn: Optional[StepClosure] = None
        self._graphed = cuda_graphs and mesh is None \
            and self.device.type == "cuda"
        # one memory pool for every graph, and one side stream for every
        # capture's warm-up (the allocator keeps a stream's freed blocks for
        # that stream alone)
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self._graphed else None
        self._capture_stream = torch.cuda.Stream(self.device) \
            if self._graphed else None
        # CUDA graphs captured, and the seconds their captures took
        self.graphs = 0
        self.capture_s = 0.0

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    @staticmethod
    def _eff_extra(req: Request) -> int:
        """Positions a request's patch embeddings take ahead of its text."""
        return req.patches.shape[0] if req.patches is not None else 0

    def add_request(self, req: Request) -> int:
        if self.phase == "decode":
            raise RuntimeError("a decode-phase engine admits nothing: its "
                               "requests arrive by attach_requests")
        if req.frames is not None:
            raise NotImplementedError(AUDIO_MSG)
        if req.patches is not None and \
                tuple(req.patches.shape[1:]) != (self.cfg.d_model,):
            raise ValueError(f"request {req.rid}: patches of shape "
                             f"{tuple(req.patches.shape)}, want (n, "
                             f"{self.cfg.d_model})")
        # the effective prompt: its patch embeddings, then its text
        eff = len(req.prompt) + self._eff_extra(req)
        if eff + req.sampling.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid}: {eff} prompt + "
                             f"{req.sampling.max_new_tokens} new tokens exceeds "
                             f"max_len={self.max_len}")
        need = pages_for(eff + req.sampling.max_new_tokens, self.ps)
        if need > self.alloc.num_pages:
            raise ValueError(f"request {req.rid}: needs {need} pages even with "
                             f"every other request evicted; pool has "
                             f"{self.alloc.num_pages} (raise "
                             f"ServingConfig.num_pages)")
        st = RequestState(request=req, slot=-1, t_submit=time.perf_counter())
        st.t_queued = st.t_submit
        st.prompt_len = eff
        st.chunk_plan = plan_chunks(eff, self.config.iso, self.cfg,
                                    whole=req.patches is not None, tp=self.tp)
        self._by_rid[req.rid] = st
        self.scheduler.add(req.rid, priority=req.priority)
        return req.rid

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.scheduler.waiting:
            rid = self.scheduler.pop_waiting()
            st = self._by_rid[rid]
            st.slot = free.pop(0)
            st.prefilled = 0
            self.slots[st.slot] = st
            self.lengths[st.slot] = 0
            self.trace.emit("admit", rid=rid, slot=st.slot)
            self._try_share_prefix(st)

    def _try_share_prefix(self, st: RequestState) -> None:
        """Map a live donor's matching prompt-prefix pages into this request
        (refcounted, nothing copied); prefill then resumes after the shared
        part."""
        if self.prefix_cache is None or st.request.patches is not None:
            return
        rid = st.request.rid
        hit = self.prefix_cache.lookup(st.request.prompt, self.alloc,
                                       exclude=rid)
        if hit is not None:
            _, t, pages = hit
            self.alloc.adopt(rid, pages, t)
            st.prefilled = t
            self.lengths[st.slot] = t
            self.metrics["prefix_shared_tokens"] += t
        self.prefix_cache.register(rid, st.request.prompt)

    def _copy_page(self, old: int, new: int) -> None:
        """Copy page ``old`` into page ``new`` in every period's k and v
        pool, in place, for copy-on-write: one closure for any (old, new)
        pair (the reference's one jitted copy), so on the card one graph.
        It runs on the engine's stream, before any later call writes the
        page."""
        fn = self._copy_page_fn
        if fn is None:
            i32 = dict(dtype=torch.int32, device=self.device)
            bufs = {"old": torch.zeros((), **i32),
                    "new": torch.zeros((), **i32)}
            pools = self.kv.k + self.kv.v

            def body():
                src = bufs["old"].reshape(1).long()
                dst = bufs["new"].reshape(1).long()
                for pool in pools:
                    pool.index_copy_(1, dst, pool.index_select(1, src))

            fn = self._copy_page_fn = StepClosure(bufs, body, self._graphed)
        host = dict(old=old, new=new)
        self._compile(fn, host)
        fn.stage(**host)
        fn()
        self.metrics["cow_copies"] += 1

    def _cow_range(self, rid: int, start: int, end: int) -> bool:
        """Copy-on-write every shared page the token range [start, end)
        writes into (evicting for the copy target if the pool is dry)."""
        table = self.alloc.tables.get(rid, [])
        for blk in range(start // self.ps, (end - 1) // self.ps + 1):
            if blk >= len(table):
                break                         # beyond the table: fresh pages
            while True:
                try:
                    pair = self.alloc.cow(rid, blk)
                    break
                except OutOfPages:
                    if not self._preempt_one(protect=[rid]):
                        return False
            if pair is not None:
                self._copy_page(*pair)
        return True

    def _preempt_one(self, protect: List[int]) -> bool:
        """Evict one running request (recompute mode).  False if none left."""
        running = [s.request.rid for s in self.slots if s is not None]
        victim = self.scheduler.pick_victim(running, protect=protect)
        if victim is None:
            return False
        st = self._by_rid[victim]
        self.trace.emit("evict", rid=victim, slot=st.slot)
        self.alloc.free(victim)
        self.slots[st.slot] = None
        self.lengths[st.slot] = 0
        self.last_tokens[st.slot] = 0
        self._drafts[st.slot] = None
        st.slot = -1
        # recompute mode: everything generated so far becomes prompt; the
        # re-prefill's last-position logits yield the next token exactly where
        # decode left off
        st.prefilled = 0
        st.chunk_plan = plan_chunks(st.prompt_len + len(st.generated),
                                    self.config.iso, self.cfg,
                                    whole=st.request.patches is not None,
                                    tp=self.tp)
        self.scheduler.requeue_front(victim)
        st.t_queued = time.perf_counter()
        self.metrics["preemptions"] += 1
        return True

    def _ensure_pages(self, rid: int, n_tokens: int) -> bool:
        """Grow rid's block table to n_tokens capacity, evicting if needed."""
        while True:
            try:
                self.alloc.ensure(rid, n_tokens)
                return True
            except OutOfPages:
                if not self._preempt_one(protect=[rid]):
                    return False

    def _resident_tokens(self, st: RequestState) -> np.ndarray:
        """Token ids the request's re-prefill covers (recompute mode folds
        generated tokens in)."""
        toks = np.asarray(st.request.prompt, np.int32)
        if st.generated:
            toks = np.concatenate([toks, np.asarray(st.generated, np.int32)])
        return toks

    def _paged_prefix(self, states=None):
        """Per-position caches exposing the page pools in place, and with
        ``states`` (per position, a dict of state NamedTuples) each
        recurrent position's state."""
        prefix, kv_i = [], 0
        for i in range(len(self.cfg.block_pattern)):
            c = dict(states[i]) if states is not None else {}
            if i in self.kv.kv_positions:
                c.update(k_pages=self.kv.k[kv_i], v_pages=self.kv.v[kv_i])
                kv_i += 1
            prefix.append(c)
        return tuple(prefix)

    def _kv_splits(self, K: int = 1) -> int:
        """Split count S of this decode step's page walk.

        ``decode_kv_splits`` 0 = auto: with a cost model, the S of the best
        measured decode time at the deepest resident request's page depth
        (a ``decision`` event with the static answer it replaced); without
        one, split by ``decode_split_factor`` only when that depth is at
        least ``decode_split_min_pages`` pages.  1 = sequential; >1 forced,
        which beats the model.  Clamped to the block-table width.  S never
        changes tokens, so a modeled S may differ from the static one."""
        sv = self.sv
        s = sv.decode_kv_splits
        if s == 0:
            deepest = pages_for(int(self.lengths.max()) + K, self.ps)
            static = sv.decode_split_factor \
                if deepest >= sv.decode_split_min_pages else 1
            s = static
            if self.cost_model is not None:
                chosen = self.cost_model.decode_splits(
                    deepest, K, max_splits=self.max_blocks)
                if chosen is not None:
                    s = chosen
                    self.trace.emit("decision", point="kv_splits",
                                    chosen=int(chosen), static=int(static),
                                    depth=int(deepest), k=int(K))
        return max(1, min(int(s), self.max_blocks))

    # ------------------------------------------------------------------
    # compiled closures
    # ------------------------------------------------------------------
    def _body_env(self) -> Tuple:
        """What a closure's body reads of the engine: (params, cfg, ctx,
        iso, kv, ps).  Bodies take these, never ``self``, so an engine and
        its closures form no reference cycle and a dropped engine frees its
        pools and graphs at once, without the cycle collector."""
        return (self.params, self.cfg, self._ctx, self.config.iso, self.kv,
                self.ps)

    def _compile(self, fn: StepClosure, host: Dict) -> None:
        """Capture ``fn`` on its first call, over the call's ``host`` inputs,
        outside the timed window of the call (which stages them again)."""
        if fn.graphed and fn.graph is None:
            with self._spans["capture"]:
                fn.stage(**host)
                self.capture_s += fn.capture(self._capture_stream,
                                             self._graph_pool)
                self.graphs += 1

    def _get_prefill(self, n_text: int, resumed: bool,
                     n_patches: int = 0) -> StepClosure:
        """Prefill closure of a (bucket-padded) grant length, fresh or
        resumed: the reference's ``(n_text, n_patches, resumed)`` key, or
        ``(n_text, resumed)`` without patches.  A patch grant (the first
        grant of a patch-carrying request, unpadded) adds the input
        ``patches`` (1, n_patches, D) fp32, prepended to its text; its
        ``start`` and ``n_real`` count the patch positions.  Inputs:
        ``tokens`` (1, n_text), the block-table
        row ``bt`` (1, MB) and the 0-d ``start`` and ``n_real``, so one
        closure serves every grant of its bucket: pad-tail tokens are
        masked out of attention (``valid_len``), scatter to the scratch
        page, and the logits come from the last real row, each through a
        device comparison or index.  A recurrent stack adds the 0-d
        ``slot``: a resumed grant starts from that slot's states (gathered
        on the device), a fresh one from zero state, and either writes its
        final states into the slot in place.  Returns the last real row's
        local logits (1, V_loc)."""
        key = (n_text, n_patches, resumed) if n_patches else \
            (n_text, resumed)
        if key in self._prefill_fns:
            return self._prefill_fns[key]
        dev, T = self.device, n_text + n_patches
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = {"tokens": torch.zeros((1, n_text), **i32),
                "bt": torch.full((1, self.max_blocks), -1, **i32),
                "start": torch.zeros((), **i32),
                "n_real": torch.zeros((), **i32)}
        states = self.states
        if self._state_tensors:
            bufs["slot"] = torch.zeros((), **i32)
        if n_patches:
            bufs["patches"] = torch.zeros((1, n_patches, self.cfg.d_model),
                                          dtype=torch.float32, device=dev)
        params, cfg, ctx, iso, kv, ps = self._body_env()
        scratch = kv.scratch_page
        pools = self._paged_prefix() if resumed else None
        hits = self.moe_hits

        def body():
            start, n_real, bt = bufs["start"], bufs["n_real"], bufs["bt"]
            slot = bufs["slot"].reshape(1).long() if "slot" in bufs \
                else None
            prefix = pools
            if resumed and slot is not None:
                # the slot's states, (P, 1, ...), beside the pools
                prefix = tuple(
                    dict(c, **{sk: type(st)(*(t.index_select(1, slot)
                                              for t in st))
                               for sk, st in states[i].items()})
                    for i, c in enumerate(pools))
            batch = {"tokens": bufs["tokens"]}
            if n_patches:
                batch["patches"] = bufs["patches"]
            out = api.prefill(
                params, cfg, ctx, iso, batch, logits_mode="none",
                prefix_caches=prefix, pos_offset=start,
                block_tables=bt if resumed else None,
                prefix_lens=start.reshape(1) if resumed else None,
                valid_len=n_real, return_extras=True, moe_hits=hits)
            # logits of the last REAL token (the pad tail carries garbage)
            h_last = out["hidden"].index_select(
                1, (n_real - 1).reshape(1).long())
            logits_last = emb_lib.lm_head_local(params["embed"],
                                                h_last)[:, 0]
            t = torch.arange(T, device=dev)
            page, off = token_page_coords(start + t, bt[0], ps, scratch)
            # pad-tail tokens must not scatter KV into live pages
            page = torch.where(t < n_real, page,
                               torch.full_like(page, scratch))
            # in-place scatter into every period's pool (the reference
            # rebuilds the pools with .at[].set)
            for kv_i, i in enumerate(kv.kv_positions):
                ex = out["extras"][i]                 # (P, 1, T, Hkv, hd)
                k_pool, v_pool = kv.k[kv_i], kv.v[kv_i]
                k_pool[:, page, off] = ex["kv_k"][:, 0].to(k_pool.dtype)
                v_pool[:, page, off] = ex["kv_v"][:, 0].to(v_pool.dtype)
            # the call's final states into the slot (the reference's
            # states.at[:, slot].set)
            for i, c in enumerate(states):
                for sk, st in c.items():
                    for big, new in zip(st, out["extras"][i][sk]):
                        big.index_copy_(1, slot, new.to(big.dtype))
            return logits_last

        self._prefill_fns[key] = StepClosure(bufs, body, self._graphed,
                                             self._mutated)
        return self._prefill_fns[key]

    def _get_prefill_batched(self, n_text: int, rows: int,
                             all_fresh: bool) -> StepClosure:
        """Prefill closure of a PACK: ``rows`` grants (row-bucket-padded) of
        one padded length ``n_text`` as one (rows, n_text) forward call, the
        reference's ``(n_text, rows, all_fresh)`` key.  Inputs: ``tokens``
        (rows, T), block tables ``bt`` (rows, MB), ``starts`` (rows,) and
        ``n_reals`` (rows,).

        Every row resumes at its own position: ``starts`` doubles as the
        paged ``prefix_lens`` (a fresh row has prefix 0, which the paged
        kernel returns as the neutral state) and ``n_reals`` masks each
        row's pad tail.  Pad rows carry an all-(-1) block table, start 0
        and n_real 0: every key masked, their KV routed to the scratch page.
        An ``all_fresh`` pack takes the dense intra-call path with no block
        tables, as the reference does.  Each row's last real position is
        picked on the device.  Returns the local logits (rows, V_loc)."""
        key = (n_text, rows, all_fresh)
        if key in self._prefill_fns:
            return self._prefill_fns[key]
        dev, T = self.device, n_text
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = {"tokens": torch.zeros((rows, T), **i32),
                "bt": torch.full((rows, self.max_blocks), -1, **i32),
                "starts": torch.zeros((rows,), **i32),
                "n_reals": torch.zeros((rows,), **i32)}
        prefix = None if all_fresh else self._paged_prefix()
        params, cfg, ctx, iso, kv, ps = self._body_env()
        scratch = kv.scratch_page
        hits = self.moe_hits

        def body():
            starts, n_reals, bt = bufs["starts"], bufs["n_reals"], bufs["bt"]
            out = api.prefill(
                params, cfg, ctx, iso,
                {"tokens": bufs["tokens"]}, logits_mode="none",
                prefix_caches=prefix, pos_offset=starts,
                block_tables=None if all_fresh else bt,
                prefix_lens=None if all_fresh else starts,
                valid_len=n_reals, return_extras=True, moe_hits=hits)
            # logits of each row's last REAL token (pad tails carry garbage)
            last = (n_reals - 1).clamp(0, T - 1).long()
            h_last = out["hidden"][torch.arange(rows, device=dev), last]
            logits_last = emb_lib.lm_head_local(params["embed"],
                                                h_last[:, None])[:, 0]
            page, off, _, _ = window_page_coords(starts, bt, T, ps, scratch)
            # pad tails and whole pad rows must not scatter into live pages
            page = torch.where(
                torch.arange(T, device=dev)[None] < n_reals[:, None], page,
                torch.full_like(page, scratch))
            for kv_i, i in enumerate(kv.kv_positions):
                ex = out["extras"][i]                 # (P, rows, T, Hkv, hd)
                k_pool, v_pool = kv.k[kv_i], kv.v[kv_i]
                k_pool[:, page, off] = ex["kv_k"].to(k_pool.dtype)
                v_pool[:, page, off] = ex["kv_v"].to(v_pool.dtype)
            return logits_last

        self._prefill_fns[key] = StepClosure(bufs, body, self._graphed,
                                             self._mutated)
        return self._prefill_fns[key]

    def prefill_compile_count(self) -> int:
        """Prefill closures built so far; each is built, and on the card
        captured, once (the reference counts its jit cache entries)."""
        return len(self._prefill_fns)

    def max_prefill_compiles(self) -> Optional[int]:
        """Bound on prefill closures under bucketing: packed, one per
        (length bucket, row bucket, all-fresh|has-resumed); batch-1, one per
        (bucket, fresh|resumed), the reference's bounds.  None when
        bucketing is off (one closure per distinct grant length)."""
        if self._buckets is None:
            return None
        if self._batch_prefill:
            return 2 * len(self._buckets) * len(self._row_buckets)
        return 2 * len(self._buckets)

    def _get_decode(self, K: int = 1, S: int = 1) -> StepClosure:
        """Decode closure of a K-token window walking the pages in S
        split-KV spans, on the engine's decode schedule: one per (K, S)."""
        key = (K, S)
        if key not in self._decode_fns:
            self._decode_fns[key] = self._build_decode_fn(
                K, S, self._decode_schedule)
        return self._decode_fns[key]

    def _get_fallback_decode(self, K: int = 1, S: int = 1) -> StepClosure:
        """Sequential decode closure for a batch-split engine's step with
        fewer than 2 decoding requests (no second half to overlap with),
        cached apart from ``_decode_fns`` as in the reference."""
        key = (K, S)
        if key not in self._decode_fallback_fns:
            self._decode_fallback_fns[key] = self._build_decode_fn(
                K, S, "sequential")
        return self._decode_fallback_fns[key]

    def _get_probe_decode(self, schedule: str, comm: bool = True
                          ) -> StepClosure:
        """Decode closure variants of the overlap probe
        (obs/overlap_probe.py): one per collective schedule (sequential,
        batch_split, cross_block, ladder, ladder_seq), plus the
        collectives-off compute floor (``comm=False`` swaps in a bare
        ``AxisCtx``, every reduce the identity).  K = 1 and S = 1: the probe
        measures schedules, not split-KV.  Cached in ``_probe_decode_fns``,
        never ``_decode_fns``."""
        key = (schedule, comm)
        if key not in self._probe_decode_fns:
            self._probe_decode_fns[key] = self._build_decode_fn(
                1, 1, schedule, ctx=None if comm else AxisCtx())
        return self._probe_decode_fns[key]

    def measure_overlap_efficiency(self, iters: int = 10, warmup: int = 3):
        """Time the decode collective schedules (sequential, batch-split,
        ladder, cross-block) on identical synthetic batches; see
        obs/overlap_probe.decode_overlap_probe."""
        from repro_torch.obs.overlap_probe import decode_overlap_probe
        return decode_overlap_probe(self, iters=iters, warmup=warmup)

    def _build_decode_fn(self, K: int, S: int, schedule: str,
                         ctx: AxisCtx = None) -> StepClosure:
        """Inputs at B = max_batch: ``toks`` (B, K), ``lengths`` (B,), the
        block tables ``bt`` (B, MB) and the decode ``mask`` (B,).  The body
        reads the pools in place, scatters the window's KV into them,
        advances the recurrent states of the slots in ``mask`` in place (the
        reference's ``jnp.where`` on ``active``) and returns the local
        logits (B, K, V_loc).  ``ctx``: the collectives'
        context, the engine's by default."""
        B, dev = self.max_batch, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = {"toks": torch.zeros((B, K), **i32),
                "lengths": torch.zeros((B,), **i32),
                "bt": torch.full((B, self.max_blocks), -1, **i32),
                "mask": torch.zeros((B,), dtype=torch.bool, device=dev)}
        caches = self._paged_prefix(self.states)
        params, cfg, engine_ctx = self._body_env()[:3]
        ctx = engine_ctx if ctx is None else ctx
        hits = self.moe_hits

        def body():
            logits, _ = api.decode_step(
                params, cfg, ctx, bufs["toks"], caches,
                bufs["lengths"], block_tables=bufs["bt"],
                decode_mask=bufs["mask"], kv_splits=S, schedule=schedule,
                moe_hits=hits)
            return logits

        return StepClosure(bufs, body, self._graphed, self._mutated)

    # ------------------------------------------------------------------
    # step phases
    # ------------------------------------------------------------------
    def _call_prefill(self, fn: StepClosure, host: Dict, label: str,
                      group: List[Tuple]) -> Tuple:
        """One fenced prefill call of ``fn`` over ``host`` (captured first if
        it must be), under the launch and wait spans and the closure-call
        range ``label``, for the prepped grants ``group`` (its rows, in
        order): when a row samples, the full vocab rows are gathered and
        picked (``_pick``).  A request of ``group`` that waited for its
        first call adds that wait to ``grant_wait_s``.  Returns (the picks
        or None, call start, fenced seconds)."""
        self._compile(fn, host)
        self._count_moe(np.size(host["tokens"]))
        sp = self._spans
        picks = None
        with sp["prefill.launch"] as launch, torchprof.annotate(label):
            fn.stage(**host)
            logits = fn()
            rows = [r for r, p in enumerate(group) if p[4]]
            if rows:
                picks = self._pick(
                    all_gather_last(logits, self._ctx), rows,
                    [r for r in rows
                     if _on_host(group[r][0].request.sampling)])
        with sp["prefill.wait"] as wait:
            synchronize(self.device)
        for st, *_ in group:
            if st.t_queued >= 0:
                self.metrics["grant_wait_s"] += launch.t0 - st.t_queued
                self.metrics["grant_wait_n"] += 1
                st.t_queued = -1.0
        return picks, launch.t0, launch.dt + wait.dt

    def _count_moe(self, rows: int) -> None:
        """A forward call of ``rows`` token rows through the stack's dropless
        MoE layers."""
        if self._moe_layers:
            self.metrics["moe_calls"] += self._moe_layers
            self.metrics["moe_rows"] += self._moe_layers * rows

    def read_moe_hits(self) -> int:
        """The local experts the dropless MoE layers' calls reached, summed
        (the device counter ``moe_hits``, read into ``moe_experts_hit``).
        Waits for the card: call it off the step path.  0 without such
        layers."""
        if self.moe_hits is None:
            return 0
        self.metrics["moe_experts_hit"] = int(self.moe_hits)
        return int(self.metrics["moe_experts_hit"])

    def _pick(self, logits: torch.Tensor, rows: List[int],
              host_rows: List[int]) -> Tuple:
        """Right after a call, while its output holds this call's gathered
        ``logits`` ((R, V_pad) or (B, K, V_pad)): every row's greedy id on
        the device, and the vocab columns of ``host_rows`` (those of the
        sampling ``rows`` that sample on the host) selected for their
        copy."""
        V = self.cfg.vocab_size
        self.metrics["sampled_rows_device"] += len(rows) - len(host_rows)
        self.metrics["sampled_rows_host"] += len(host_rows)
        # the greedy ids are indexed on the host: a list index on the device
        # is copied from pageable memory and waits for the replay to end
        return (rows, pick_greedy(logits, V), host_rows,
                logits[host_rows, ..., :V] if host_rows else None)

    def _fetch(self, picks: Tuple) -> Tuple[Dict, Dict]:
        """After the fence, under ``engine/logits.to_host``: the picked ids
        to the host, and the host rows' logits (fp32) when there are any;
        each as ``{row: ...}`` over the rows that sample."""
        rows, ids, host_rows, logits = picks
        with self._spans["logits.to_host"]:
            ids = ids.cpu().numpy()
            logits = logits.float().cpu().numpy() if host_rows else ()
        return {r: ids[r] for r in rows}, dict(zip(host_rows, logits))

    def _run_grant(self, st: RequestState, start: int, n_tokens: int,
                   padded: int, last: bool,
                   events: List[Tuple[int, int]]) -> None:
        """Execute one prefill grant, sampling its token if ``last``.
        ``padded`` (>= n_tokens) is the forward-call length; the pad tail is
        token 0, masked out of attention and scattered to the scratch page."""
        req = st.request
        # a request's patches take the first effective positions of its
        # first grant; a later grant (a cut tail, or text) covers text from
        # the text offset t0
        extra = self._eff_extra(req)
        n_patches = extra if start == 0 else 0
        t0 = max(0, start - extra)
        n_text = n_tokens - n_patches
        buf = np.zeros(padded - n_patches, np.int32)
        buf[:n_text] = self._resident_tokens(st)[t0:t0 + n_text]
        fn = self._get_prefill(padded - n_patches, resumed=start > 0,
                               n_patches=n_patches)
        host = dict(tokens=buf[None],
                    bt=self.alloc.block_table(req.rid, self.max_blocks)[None],
                    start=start, n_real=n_tokens)
        if "slot" in fn.inputs:
            host["slot"] = st.slot
        if n_patches:
            host["patches"] = np.asarray(req.patches, np.float32)[None]
        group = [(st, start, n_tokens, padded, last)]
        picks, t0, dur = self._call_prefill(fn, host, f"prefill/T={padded}",
                                            group)
        self.metrics["prefill_tokens"] += n_tokens
        self.metrics["prefill_pad_tokens"] += padded - n_tokens
        self.metrics["prefill_calls"] += 1
        self.trace.emit("prefill_call", rid=st.request.rid, slot=st.slot,
                        dur=dur, ts=t0, tokens=n_tokens,
                        pad=padded - n_tokens, rows=1)
        self._commit_rows(group, picks, events)

    def _commit_rows(self, group: List[Tuple], picks,
                     events: List[Tuple[int, int]]) -> None:
        """After a prefill call over prepped grants ``group`` (its rows, in
        order): the picks to the host when a row samples, then each row's
        commit and token (its greedy id, or sampled from its logits on the
        host), and the requests it finished retired."""
        if picks is not None:
            ids, logits = self._fetch(picks)
        with self._spans["sample"]:
            for r, (st, start, n, _, last) in enumerate(group):
                tok = None
                if last:
                    tok = sample(logits[r], st.request.sampling,
                                 step=len(st.generated)) if r in logits \
                        else int(ids[r])
                tok = self._commit_grant_row(st, start, n, tok)
                if tok is not None:
                    events.append((st.request.rid, tok))
                    if st.done:
                        self._finish(st)

    def _commit_grant_row(self, st: RequestState, start: int, n_tokens: int,
                          tok: Optional[int]) -> Optional[int]:
        """Post-forward bookkeeping for one grant (batch-1 or a pack's row):
        commit tokens, advance prefill progress and, for a prompt-finishing
        grant (``tok``, its sampled first token, not None), stamp TTFT and
        (re)build the speculative self-draft."""
        last = tok is not None
        req = st.request
        slot = st.slot
        self.alloc.commit(req.rid, n_tokens)
        st.prefilled = start + n_tokens
        self.lengths[slot] = st.prefilled
        self.metrics["prefill_grants"] += 1
        if start > 0:
            self.metrics["resumed_grants"] += 1
        # a scheduler grant can be dropped and re-issued (packmate eviction,
        # deferred sharing): the commit is the countable event
        self.trace.emit("grant_commit", rid=req.rid, slot=slot, start=start,
                        n=n_tokens, last=last)
        if not last:
            return None
        self.metrics["prefill_samples"] += 1
        first = st.t_first < 0
        if first:
            st.t_first = time.perf_counter()
            ttft = st.t_first - st.t_submit
            self.metrics["ttft_sum"] += ttft
            self.metrics["ttft_n"] += 1
        self.trace.emit("sample", rid=req.rid, slot=slot, first=first)
        if self.spec_k:
            # (re)build the self-draft over everything resident: after a
            # recompute preemption that includes the generated tokens
            d = BigramDraft()
            d.observe([int(t) for t in self._resident_tokens(st)] + [int(tok)])
            self._drafts[slot] = d
        st.generated.append(tok)
        self.last_tokens[slot] = tok
        st.finish_check()
        return tok

    def _run_pack(self, group: List[Tuple], padded: int,
                  events: List[Tuple[int, int]]) -> None:
        """Execute prepped grants ``group`` [(st, start, n_tokens, padded,
        last), ...] of one padded length as ONE forward call, the row count
        padded up to a row bucket (pad rows: empty block table, n_real 0)."""
        R = len(group)
        rows = round_to_bucket(R, self._row_buckets)
        T = padded
        toks = np.zeros((rows, T), np.int32)
        starts = np.zeros(rows, np.int32)
        n_reals = np.zeros(rows, np.int32)
        bts = np.full((rows, self.max_blocks), -1, np.int32)
        for r, (st, start, n, _, _last) in enumerate(group):
            toks[r, :n] = self._resident_tokens(st)[start:start + n]
            starts[r] = start
            n_reals[r] = n
            bts[r] = self.alloc.block_table(st.request.rid, self.max_blocks)
        fn = self._get_prefill_batched(T, rows,
                                       all_fresh=bool(np.all(starts == 0)))
        host = dict(tokens=toks, bt=bts, starts=starts, n_reals=n_reals)
        picks, t0, dur = self._call_prefill(fn, host,
                                            f"prefill/T={T}x{rows}", group)
        n_total = int(n_reals.sum())
        self.metrics["prefill_tokens"] += n_total
        self.metrics["prefill_pad_tokens"] += rows * T - n_total
        self.metrics["prefill_pad_rows"] += rows - R
        self.metrics["prefill_calls"] += 1
        self.trace.emit("prefill_call", dur=dur, ts=t0, tokens=n_total,
                        pad=rows * T - n_total, rows=R)
        self._commit_rows(group, picks, events)

    def _finish(self, st: RequestState) -> None:
        self.metrics["completed"] += 1
        self.trace.emit("finish", rid=st.request.rid, slot=st.slot)
        self.alloc.free(st.request.rid)
        if self.prefix_cache is not None:
            self.prefix_cache.forget(st.request.rid)
        self.scheduler.forget(st.request.rid)
        self._finished.append(st)
        self._by_rid.pop(st.request.rid, None)
        self.slots[st.slot] = None
        self.lengths[st.slot] = 0
        self.last_tokens[st.slot] = 0
        self._drafts[st.slot] = None
        st.slot = -1

    def _prep_grant(self, g: PrefillGrant) -> Optional[Tuple]:
        """Per-grant pre-work of the batch-1 and packed paths: the prefix
        sharing retry, page growth and copy-on-write (both may evict).
        Returns (st, start, n_tokens, padded, last), or None when the grant
        dissolved (its request was evicted by an earlier grant, or sharing
        this step covered it)."""
        st = self._by_rid.get(g.rid)
        if st is None or st.slot < 0:
            return None                       # preempted by an earlier grant
        start, end = g.start, g.start + g.n_tokens
        if start == 0 and st.prefilled == 0:
            # retry sharing: a donor granted earlier this step (batch-1: its
            # call ran; packed: an earlier pack) has committed by now
            self._try_share_prefix(st)
            start = st.prefilled
            if end <= start:                  # grant fully covered by sharing
                return None
        if not self._ensure_pages(g.rid, end) or \
                not self._cow_range(g.rid, start, end):
            raise RuntimeError(
                f"page pool too small for request {g.rid}'s prefill chunk "
                f"even after evicting; increase ServingConfig.num_pages")
        # the scheduler rounded the grant; re-round only when sharing this
        # step shrank it
        n = end - start
        if st.request.patches is not None:    # patch grants: never padded
            padded = n
        elif start == g.start and n == g.n_tokens:
            padded = g.padded or n
        elif self._buckets is None:
            padded = n
        else:
            padded = round_to_bucket(n, self._buckets)
        return st, start, n, padded, g.last

    def _prefill_phase(self, events: List[Tuple[int, int]]) -> None:
        # prefill target = sum(chunk_plan): the prompt at admission, or
        # prompt+generated after a recompute preemption
        pending = [(s.request.rid, s.prefilled, s.chunk_plan)
                   for s in self.slots
                   if s is not None and s.prefilled < sum(s.chunk_plan)]
        grants = self.scheduler.grant_prefill(pending)
        if not self._batch_prefill:
            for g in grants:
                prep = self._prep_grant(g)
                if prep is None:
                    continue
                self._run_grant(*prep, events)
            return
        # packed: prep runs pack by pack in policy order, so eviction and
        # copy-on-write go as on the batch-1 path; a prep that evicts a
        # packmate drops it (slot check in _run_groups), and sharing that
        # shrank a grant moves it to a sub-pack of its new padded length.  A
        # fresh grant that could share with a PACKMATE waits for a follow-up
        # sub-pack: sharing adopts committed tokens only, and packmates
        # commit together after their call.
        for pack in self.scheduler.pack_grants(grants,
                                               max_rows=self.max_batch):
            ready, deferred = [], []
            for g in pack:
                if self._defer_for_packmate_sharing(g, ready):
                    self.trace.emit("defer", rid=g.rid)
                    deferred.append(g)
                    continue
                prep = self._prep_grant(g)
                if prep is not None:
                    ready.append(prep)
            self._run_groups(ready, events)
            if deferred:
                # the donors committed above; _prep_grant's sharing retry
                # now engages for the sharees
                self._run_groups(
                    [p for g in deferred
                     if (p := self._prep_grant(g)) is not None], events)

    def _defer_for_packmate_sharing(self, g: PrefillGrant,
                                    prepped: List[Tuple]) -> bool:
        """True if fresh grant ``g`` shares its first page's worth of prompt
        with an earlier member of the same pack: the one case where packing
        would lose a share the batch-1 path gets."""
        if self.prefix_cache is None or not prepped:
            return False
        st = self._by_rid.get(g.rid)
        if st is None or st.slot < 0 or st.prefilled > 0 or g.start != 0:
            return False
        prompt = np.asarray(st.request.prompt, np.int32)
        if len(prompt) < self.ps:
            return False                  # sharing needs a full page match
        head = prompt[:self.ps]
        for p_st, _, _, _, _ in prepped:
            donor = np.asarray(p_st.request.prompt, np.int32)
            if len(donor) >= self.ps and np.array_equal(donor[:self.ps], head):
                return True
        return False

    def _run_groups(self, ready: List[Tuple],
                    events: List[Tuple[int, int]]) -> None:
        """Run prepped grants as packs, sub-grouped by their final padded
        length (sharing this step may have re-bucketed some)."""
        ready = [p for p in ready if p[0].slot >= 0]
        by_len: Dict[int, List[Tuple]] = {}
        for p in ready:
            by_len.setdefault(p[3], []).append(p)
        for padded, group in by_len.items():
            self._run_pack(group, padded, events)

    # accept-length samples the spec gate needs before it trusts the
    # histogram's mean (tests monkeypatch this)
    SPEC_GATE_MIN_SAMPLES = 8

    def _spec_window(self, active: List[RequestState]) -> int:
        """Verify-window width of this decode step: spec_k+1 when every
        active request can speculate (greedy, drafted, the whole window
        under max_len) and the window's pages fit without eviction, else 1.

        With a cost model, once the ``accept_len`` histogram holds
        ``SPEC_GATE_MIN_SAMPLES`` samples, the window is skipped (K=1, a
        ``spec_gate`` decision) whenever the measured K-token verify costs
        at least the plain steps its mean accept length replaces
        (``CostModel.spec_worth``).  Skipping is token-neutral: greedy
        verify equals plain decode."""
        if not self.spec_k:
            return 1
        K = self.spec_k + 1
        if self.cost_model is not None:
            hist = self.registry.histogram("accept_len")
            if hist.n >= self.SPEC_GATE_MIN_SAMPLES:
                deepest = pages_for(int(self.lengths.max()) + K, self.ps)
                worth = self.cost_model.spec_worth(K, deepest, hist.mean)
                if worth is False:
                    self.trace.emit("decision", point="spec_gate", chosen=1,
                                    static=K,
                                    expected_accept=float(hist.mean))
                    return 1
        need = 0
        for st in active:
            L = int(self.lengths[st.slot])
            if st.request.sampling.temperature > 0 or \
                    self._drafts[st.slot] is None or L + K > self.max_len:
                return 1
            need += max(0, pages_for(L + K, self.ps)
                        - len(self.alloc.tables.get(st.request.rid, ())))
        # admission validated only the plain-decode watermark: evicting a
        # request to speculate on another would trade progress for guesses
        if need > self.alloc.free_pages:
            return 1
        return K

    def _decode_phase(self, events: List[Tuple[int, int]]) -> None:
        active = [s for s in self.slots
                  if s is not None and not s.done and s.generated
                  and s.prefilled >= sum(s.chunk_plan)]
        if not active:
            return
        K = self._spec_window(active)
        # grow every decoder's capacity by the window and copy the shared
        # pages it writes (may evict; an evicted request drops out of
        # `active` by its slot)
        for st in active:
            if st.slot < 0:
                continue
            L = int(self.lengths[st.slot])
            if not self._ensure_pages(st.request.rid, L + K) or \
                    not self._cow_range(st.request.rid, L, L + K):
                raise RuntimeError(
                    f"page pool too small for a {K}-token decode step; "
                    f"increase ServingConfig.num_pages")
        active = [s for s in active if s.slot >= 0]
        if not active:
            return
        B = self.max_batch
        mask = np.zeros(B, bool)
        for st in active:
            mask[st.slot] = True
        bt = np.stack([self.alloc.block_table(s.request.rid, self.max_blocks)
                       if s is not None and mask[i] else
                       np.full(self.max_blocks, -1, np.int32)
                       for i, s in enumerate(self.slots)])
        toks = np.zeros((B, K), np.int32)
        toks[:, 0] = self.last_tokens
        drafts: Dict[int, List[int]] = {}
        if K > 1:
            for st in active:
                drafts[st.slot] = self._drafts[st.slot].draft(self.spec_k)
                toks[st.slot, 1:] = drafts[st.slot]
        S = self._kv_splits(K)
        self.decode_splits[S] = self.decode_splits.get(S, 0) + 1
        if self._decode_schedule == "batch_split" and len(active) < 2:
            # one decoding request has no second batch half to overlap with
            schedule, fn = "sequential", self._get_fallback_decode(K, S)
            self.trace.emit("decision", point="decode_schedule",
                            fallback=1, active=len(active), k=int(K))
        else:
            schedule, fn = self._decode_schedule, self._get_decode(K, S)
        self.decode_schedule_steps[schedule] = \
            self.decode_schedule_steps.get(schedule, 0) + 1
        host = dict(toks=toks, lengths=self.lengths, bt=bt, mask=mask)
        self._compile(fn, host)
        self._count_moe(toks.size)
        sp = self._spans
        rows = [st.slot for st in active]
        # rows that sample on the host (never in a verify window: the gate
        # takes K > 1 only when every decoding request is greedy)
        host_rows = [st.slot for st in active
                     if _on_host(st.request.sampling)]
        with sp["decode.launch"] as launch, \
                torchprof.annotate(f"decode/K={K}/S={S}"):
            fn.stage(**host)
            picks = self._pick(all_gather_last(fn(), self._ctx), rows,
                               host_rows)
        with sp["decode.wait"] as wait:
            synchronize(self.device)
        dur = launch.dt + wait.dt
        ids, logits = self._fetch(picks)
        self.metrics["decode_calls"] += 1
        self.trace.emit("decode_call", dur=dur, ts=launch.t0, k=K,
                        active=len(active))
        if K > 1:
            self.metrics["spec_calls"] += 1
        with sp["sample"]:
            # rejected window positions: the reference invalidates their
            # pos entries; the port has no pos pool (its KV past a length is
            # never read) and narrates the same count
            rejected = 0
            for st in active:
                i = st.slot
                if K == 1:
                    acc = [sample(logits[i][0], st.request.sampling,
                                  len(st.generated)) if i in logits
                           else int(ids[i][0])]
                    if self._drafts[i] is not None:
                        # keep the draft fresh across K=1 fallbacks, or the
                        # next verify drafts from a stale anchor
                        self._drafts[i].observe([int(acc[0])])
                else:
                    # greedy accept: the longest matching prefix of the
                    # drafts, plus the model's bonus token when all of them
                    # hit; the rejected positions' KV stays past the
                    # length, unread
                    budget = st.request.sampling.max_new_tokens \
                        - len(st.generated)
                    acc = accept_greedy(drafts[i], ids[i])[:max(budget, 1)]
                    self.metrics["spec_tokens"] += len(acc)
                    self.registry.histogram("accept_len").observe(len(acc))
                    self._drafts[i].observe([int(t) for t in acc])
                    rejected += K - len(acc)
                self.alloc.commit(st.request.rid, len(acc))
                self.metrics["decode_tokens"] += len(acc)
                self.trace.emit("accept", rid=st.request.rid, slot=i,
                                n=len(acc), spec=K > 1)
                self.registry.histogram("tpot").observe(dur / len(acc))
                for tok in acc:
                    st.generated.append(int(tok))
                    events.append((st.request.rid, int(tok)))
                self.lengths[i] += len(acc)
                self.last_tokens[i] = int(acc[-1])
                st.finish_check()
                if st.done:
                    self._finish(st)
            if rejected:
                self.trace.emit("spec_rollback", n=rejected)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admission -> budgeted prefill grants ->
        batched decode.  Returns (rid, token) events."""
        t0 = time.perf_counter()
        events: List[Tuple[int, int]] = []
        # the schedule span holds the step; the other phases pause it
        with self._spans["schedule"]:
            self.metrics["steps"] += 1
            if self.scheduler.runs_prefill:
                self._admit()
                self._prefill_phase(events)
            if self.scheduler.runs_decode:
                self._decode_phase(events)
            used = self.alloc.used_pages
            self.metrics["peak_used_pages"] = max(
                self.metrics["peak_used_pages"], used)
            self.trace.emit("pool", used=used, free=self.alloc.free_pages,
                            frag=self.alloc.fragmentation())
        self.metrics["step_s"] += time.perf_counter() - t0
        return events

    def run_until_complete(self, max_steps: int = 10_000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if not self.scheduler.waiting and \
                    all(s is None for s in self.slots):
                break
        return {st.request.rid: st.generated for st in self._finished}

    # ------------------------------------------------------------------
    # disaggregated serving: detach / attach (serving/disagg.py)
    # ------------------------------------------------------------------
    def detach_requests(self, rids: List[int]):
        """Export ``rids``' KV pages and lifecycle state as a
        ``PageTransfer`` and REMOVE the requests from this engine (slots
        cleared, pages freed, scheduler and prefix-cache entries dropped).

        The requests must be resident with their prompts fully committed,
        the set the router migrates.  Pages shared within the detached
        group are exported once; pages shared with a request that stays are
        copied by the export and stay with it.  The transfer is host state
        only (numpy payloads, plain records).  Runs between steps."""
        from repro_torch.serving.disagg import PageTransfer, RequestRecord
        t0 = time.perf_counter()
        blob = self.pool.export_pages(rids)
        records = []
        for rid in rids:
            st = self._by_rid[rid]
            slot = st.slot
            assert slot >= 0, f"detach of non-resident request {rid}"
            assert st.prefilled >= sum(st.chunk_plan), \
                f"detach of mid-prefill request {rid}"
            d = self._drafts[slot]
            records.append(RequestRecord(
                request=st.request, generated=list(st.generated),
                prompt_len=st.prompt_len, prefilled=st.prefilled,
                chunk_plan=tuple(st.chunk_plan), t_submit=st.t_submit,
                t_first=st.t_first, last_token=int(self.last_tokens[slot]),
                draft_table=dict(d.table) if d is not None else None,
                draft_last=d.last if d is not None else -1))
            self.trace.emit("detach", rid=rid, slot=slot)
            self.alloc.free(rid)
            if self.prefix_cache is not None:
                self.prefix_cache.forget(rid)
            self.scheduler.forget(rid)
            self._by_rid.pop(rid, None)
            self.slots[slot] = None
            self.lengths[slot] = 0
            self.last_tokens[slot] = 0
            self._drafts[slot] = None
            st.slot = -1
        us = (time.perf_counter() - t0) * 1e6
        # one span a transfer, n = DISTINCT pages moved: replay rebuilds
        # migrations and migrated_pages from these events
        self.trace.emit("migrate", n=blob["n_pages"], rids=len(rids), us=us)
        self.metrics["migrations"] += 1
        self.metrics["migrated_pages"] += blob["n_pages"]
        self.metrics["migration_us"] += us
        return PageTransfer(records=records, blob=blob)

    def attach_requests(self, transfer) -> None:
        """Adopt a ``PageTransfer``: import its pages into this pool (in
        place) and install the requests into free slots, decode-ready.

        Raises ``OutOfPages``, atomically (nothing mutated), when the free
        list cannot host the transfer's distinct pages; the router keeps the
        transfer and retries (an attach never evicts a resident request).
        Free slots must cover the records (the router checks first).  The
        next decode step stages the attached ``lengths`` and
        ``last_tokens`` into its static buffers."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        assert len(free) >= len(transfer.records), \
            (len(free), len(transfer.records))
        t0 = time.perf_counter()
        self.pool.import_pages(transfer.blob)   # may raise OutOfPages: atomic
        synchronize(self.device)
        for rec in transfer.records:
            rid = rec.request.rid
            slot = free.pop(0)
            st = RequestState(request=rec.request, slot=slot,
                              generated=list(rec.generated),
                              prompt_len=rec.prompt_len,
                              t_submit=rec.t_submit)
            st.prefilled = rec.prefilled
            st.chunk_plan = tuple(rec.chunk_plan)
            st.t_first = rec.t_first
            self.slots[slot] = st
            self._by_rid[rid] = st
            # the committed tokens came over in the blob's lengths; the last
            # sampled token is not in KV yet (it is the next decode input)
            self.lengths[slot] = self.alloc.tokens(rid)
            self.last_tokens[slot] = rec.last_token
            if self.spec_k and rec.draft_table is not None:
                d = BigramDraft()
                d.table = dict(rec.draft_table)
                d.last = rec.draft_last
                self._drafts[slot] = d
            # arrival bookkeeping without queueing: pick_victim and order
            # need a key for migrated-in requests
            self.scheduler.register(rid, priority=rec.request.priority)
            self.trace.emit("attach", rid=rid, slot=slot)
        self.metrics["migration_us"] += (time.perf_counter() - t0) * 1e6

    def accepted_per_call(self) -> float:
        """Mean tokens emitted per speculative verify call (>= 1 once any
        verify ran; 0.0 when speculation never triggered)."""
        if not self.metrics["spec_calls"]:
            return 0.0
        return self.metrics["spec_tokens"] / self.metrics["spec_calls"]

    def page_stats(self) -> Dict[str, object]:
        return self.pool.stats()
