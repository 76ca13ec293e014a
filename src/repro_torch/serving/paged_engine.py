"""Paged continuous-batching engine: chunked prefill interleaved with decode
(port of the base loop and the compiled closures of
``repro/serving/paged_engine.py``).

KV memory is a shared page pool (serving/kvcache.py).  Each ``step()``:

  * admits waiting requests into free slots;
  * runs this step's token-budget slice of prefill grants, one batch-1
    forward call per grant, padded up to a bucket length
    (``core/chunking.grant_buckets``) with the pad tail masked out of
    attention and routed to the scratch page.  A fresh grant attends only
    its own tokens (the dense intra path); a resumed grant reads its
    page-resident prefix in place through the paged flash-prefill kernel.
    Inside each call the ISO chunk order of ``core/iso.run_layer`` applies;
  * runs ONE batched K=1 decode step over all slots whose prompt is
    resident, reading the pools in place through the paged flash-decode
    kernel, split into S spans by ``_kv_splits``, and scattering the new
    token's KV into its page in place.

Compiled closures.  As the reference jits one prefill closure per (bucket,
fresh|resumed) and one decode closure per (K, S), the port builds one
``StepClosure`` per key: static input buffers of the key's shape (tokens,
lengths, block tables, the decode mask; a grant's tokens, block-table row and
the device scalars ``start`` and ``n_real``) and the step's body over them.
A step copies its host arrays into the buffers and calls the closure.  On
the card at tp=1 the body is captured once per key in a
``torch.cuda.CUDAGraph`` (every graph drawing on one shared memory pool) and
each call is one replay, the counterpart of calling a ``jax.jit``
executable; ``cuda_graphs=False`` runs the same bodies eagerly, as
``jax.disable_jit()`` would.  A failed capture or replay raises; nothing
gives way to the eager path.  On the CPU, and in a TP engine, the bodies run
eagerly over the same buffers: a TP engine's collectives go through gloo on
the host, which a graph cannot hold, and capturing NCCL collectives waits on
ROADMAP queue A item 7.

Tensor parallelism: ``mesh=`` takes this rank's ``launch.mesh.TPGroup``;
``params`` are then the rank's shard (``bridge.shard_params`` or
``api.init_params(..., rank=)``) and the pool holds its share of the kv
heads.  Every rank runs this same host loop on the same requests, so every
rank takes the same decisions; the vocab-sharded logits are gathered before
sampling, so every rank samples the same token.  The decode collective
schedule follows the reference: ``auto`` is ``batch_split`` under TP when
``decode_overlap`` and ``max_batch >= 2`` (``sequential`` otherwise), with
a sequential step whenever fewer than 2 requests decode; ``sequential``,
``batch_split`` and ``cross_block`` can be forced.

When the pool runs dry a victim is evicted (recompute preemption: its pages
are freed and prompt + generated re-enter the waiting queue).  Settings
outside the port's slice raise ``NotImplementedError`` naming their ROADMAP
item rather than doing something else.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import Config, ServingConfig, padded_vocab
from repro_torch.core.chunking import grant_buckets
from repro_torch.core.iso import DECODE_SCHEDULES
from repro_torch.core.overlap import AxisCtx, all_gather_last
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import native
from repro_torch.launch.mesh import TPGroup
from repro_torch.layers import embeddings as emb_lib
from repro_torch.models import api
from repro_torch.models.decoder import check_supported
from repro_torch.serving.kvcache import OutOfPages, pages_for, \
    token_page_coords
from repro_torch.serving.kvstate import KVPool
from repro_torch.serving.requests import Request, RequestState
from repro_torch.serving.sampler import sample
from repro_torch.serving.scheduler import TokenBudgetScheduler, plan_chunks

# the reference engine's metric keys for the phases the port runs
METRIC_KEYS = (
    "prefill_s", "decode_s", "prefill_dispatch_s", "decode_dispatch_s",
    "prefill_tokens", "decode_tokens", "completed", "decode_calls",
    "prefill_calls", "steps", "preemptions", "ttft_sum", "ttft_n",
    "peak_used_pages", "prefill_pad_tokens", "prefill_samples",
    "prefill_grants", "resumed_grants")


class StepClosure:
    """One compiled step: static input buffers of a fixed shape, the step's
    body over them, and, once ``capture`` has run, the CUDA graph of that
    body (the port's counterpart of one ``jax.jit`` executable).

    ``stage`` copies host arrays into the buffers (on the card through
    pinned staging buffers, without waiting: the engine fences every call
    before it stages the next).  Calling the closure runs the body, or
    replays the graph and returns its static output, which the next replay
    of any graph of the shared pool may overwrite: callers copy out what
    they keep first.  A replay adds to the kernels' launch counters the
    launches its capture recorded, so the counts stay those of the kernels
    that ran."""

    def __init__(self, buffers: Dict[str, torch.Tensor], body,
                 graphed: bool):
        self.inputs = buffers
        self._body = torch.no_grad()(body)
        self.graphed = graphed
        on_card = next(iter(buffers.values())).device.type == "cuda"
        self._pinned = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in buffers.items()} if on_card else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._launches: Dict[str, int] = {}

    def stage(self, **host) -> None:
        """Copy host arrays (numpy or ints) into the input buffers."""
        for name, value in host.items():
            if self._pinned is None:
                self.inputs[name].numpy()[...] = value
            else:
                pin = self._pinned[name]
                pin.numpy()[...] = value
                self.inputs[name].copy_(pin, non_blocking=True)

    def capture(self, side: torch.cuda.Stream, pool) -> float:
        """Record the body in a CUDA graph drawing on the memory ``pool``;
        returns the seconds it took.  The body first runs once on the side
        stream ``side`` over the staged inputs, so the kernels' library is
        loaded, their attributes are set and B1's arrival counters are
        grown before the capture, which must allocate nothing that outlives
        it.  The warm-up writes the KV the replay then writes again."""
        dev = next(iter(self.inputs.values())).device
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = native.launch_counts()
        with torch.cuda.graph(graph, pool=pool):
            out = self._body()
        # the capture recorded these launches; replays make them
        after = native.launch_counts()
        self._launches = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        native.add_launches({k: -n for k, n in self._launches.items()})
        self.graph, self._out = graph, out
        synchronize(dev)
        return time.perf_counter() - t0

    def __call__(self):
        if not self.graphed:
            return self._body()
        if self.graph is None:
            raise RuntimeError("a graphed step closure was called before "
                               "its capture")
        self.graph.replay()
        native.add_launches(self._launches)
        return self._out


def _check_slice(sv: ServingConfig) -> None:
    """Raise for every setting the port's slice does not run."""
    if sv.decode_schedule not in ("auto",) + DECODE_SCHEDULES:
        raise ValueError(f"decode_schedule={sv.decode_schedule!r}: one of "
                         f"auto, {', '.join(DECODE_SCHEDULES)}")
    todo = []
    if sv.prefix_sharing:
        todo.append("prefix_sharing=True (pass prefix_sharing=False): "
                    "ROADMAP queue A item 8")
    if sv.prefill_batching:
        todo.append("prefill_batching=True (pass prefill_batching=False): "
                    "ROADMAP queue A item 8")
    if sv.spec_k:
        todo.append("spec_k>0 (speculative decoding): ROADMAP queue A item 8")
    if sv.cost_table or sv.cost_model is not None:
        todo.append("cost_table/cost_model: ROADMAP queue A item 9")
    if sv.disagg:
        todo.append("disagg (disaggregated serving): ROADMAP queue A item 9")
    if todo:
        raise NotImplementedError("not in the port's slice yet: "
                                  + "; ".join(todo))


class PagedEngine:
    """``cuda_graphs`` (default True) captures each step closure in a CUDA
    graph on the card at tp=1; False runs the closures eagerly (A/B runs,
    the eager-vs-graphed check).  CPU and TP engines always run them
    eagerly (module doc)."""

    def __init__(self, config: Config, params, *,
                 serving: ServingConfig = None, mesh: TPGroup = None,
                 device=None, cuda_graphs: bool = True):
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
        _check_slice(sv)
        check_supported(config.model)
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
        num_pages = sv.num_pages or sv.max_batch * self.max_blocks
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
        if sv.decode_schedule == "auto":
            self._decode_schedule = "batch_split" \
                if (mesh is not None and sv.decode_overlap
                    and sv.max_batch >= 2) else "sequential"
        else:
            self._decode_schedule = sv.decode_schedule
        # decode steps run per schedule (batch_split falls back to
        # sequential on steps with fewer than 2 decoding requests)
        self.decode_schedule_steps: Dict[str, int] = {}
        self.pool = KVPool.create(self.cfg, num_pages, self.ps, tp=self.tp,
                                  dtype=table.dtype, device=self.device)
        self.alloc = self.pool.alloc
        self.kv = self.pool.kv
        self._buckets = grant_buckets(sv.max_len, sv.min_grant_bucket,
                                      sv.grant_buckets) \
            if sv.grant_bucketing else None
        self.scheduler = TokenBudgetScheduler(
            policy=sv.scheduler_policy,
            prefill_token_budget=sv.prefill_token_budget,
            grant_buckets=self._buckets)
        self.slots: List[Optional[RequestState]] = [None] * sv.max_batch
        self.lengths = np.zeros(sv.max_batch, np.int64)   # tokens resident
        self.last_tokens = np.zeros(sv.max_batch, np.int64)
        self._by_rid: Dict[int, RequestState] = {}        # waiting + running
        self._finished: List[RequestState] = []
        self.metrics: Dict[str, float] = dict.fromkeys(METRIC_KEYS, 0)
        # decode steps run per split count S
        self.decode_splits: Dict[int, int] = {}
        # compiled closures, keyed as the reference's jit caches: prefill
        # (bucket, resumed); decode (K, S); the batch-split engine's
        # sequential fallback (K, S) apart, so the decode keys stay
        # schedule-pure
        self._prefill_fns: Dict[Tuple[int, bool], StepClosure] = {}
        self._decode_fns: Dict[Tuple[int, int], StepClosure] = {}
        self._decode_fallback_fns: Dict[Tuple[int, int], StepClosure] = {}
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
    def add_request(self, req: Request) -> int:
        if req.frames is not None or req.patches is not None:
            raise NotImplementedError("audio/vision requests: ROADMAP queue "
                                      "A item 10")
        eff = len(req.prompt)
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
        st.prompt_len = eff
        st.chunk_plan = plan_chunks(eff, self.config.iso, self.cfg)
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

    def _preempt_one(self, protect: List[int]) -> bool:
        """Evict one running request (recompute mode).  False if none left."""
        running = [s.request.rid for s in self.slots if s is not None]
        victim = self.scheduler.pick_victim(running, protect=protect)
        if victim is None:
            return False
        st = self._by_rid[victim]
        self.alloc.free(victim)
        self.slots[st.slot] = None
        self.lengths[st.slot] = 0
        self.last_tokens[st.slot] = 0
        st.slot = -1
        # recompute mode: everything generated so far becomes prompt; the
        # re-prefill's last-position logits yield the next token exactly where
        # decode left off
        st.prefilled = 0
        st.chunk_plan = plan_chunks(st.prompt_len + len(st.generated),
                                    self.config.iso, self.cfg)
        self.scheduler.requeue_front(victim)
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

    def _paged_prefix(self):
        """Per-position prefill caches exposing the page pools in place."""
        prefix, kv_i = [], 0
        for i in range(len(self.cfg.block_pattern)):
            c = {}
            if i in self.kv.kv_positions:
                c = {"k_pages": self.kv.k[kv_i], "v_pages": self.kv.v[kv_i]}
                kv_i += 1
            prefix.append(c)
        return tuple(prefix)

    def _kv_splits(self, K: int = 1) -> int:
        """Split count S of this decode step's page walk.

        ``decode_kv_splits`` 0 = auto: split by ``decode_split_factor`` only
        when the deepest resident request spans at least
        ``decode_split_min_pages`` pages; 1 = sequential; >1 forced.
        Clamped to the block-table width.  (The reference's cost-model
        choice is not ported.)"""
        sv = self.sv
        s = sv.decode_kv_splits
        if s == 0:
            deepest = pages_for(int(self.lengths.max()) + K, self.ps)
            s = sv.decode_split_factor \
                if deepest >= sv.decode_split_min_pages else 1
        return max(1, min(int(s), self.max_blocks))

    # ------------------------------------------------------------------
    # compiled closures
    # ------------------------------------------------------------------
    def _compile(self, fn: StepClosure, host: Dict) -> None:
        """Capture ``fn`` on its first call, over the call's ``host`` inputs,
        outside the timed window of the call (which stages them again)."""
        if fn.graphed and fn.graph is None:
            fn.stage(**host)
            self.capture_s += fn.capture(self._capture_stream,
                                         self._graph_pool)
            self.graphs += 1

    def _get_prefill(self, n_text: int, resumed: bool) -> StepClosure:
        """Prefill closure of a (bucket-padded) grant length, fresh or
        resumed: the reference's ``(n_text, n_patches, resumed)`` key
        without patches.  Inputs: ``tokens`` (1, n_text), the block-table
        row ``bt`` (1, MB) and the 0-d ``start`` and ``n_real``, so one
        closure serves every grant of its bucket: pad-tail tokens are
        masked out of attention (``valid_len``), scatter to the scratch
        page, and the logits come from the last real row, each through a
        device comparison or index.  Returns the last real row's local
        logits (1, V_loc)."""
        key = (n_text, resumed)
        if key in self._prefill_fns:
            return self._prefill_fns[key]
        dev, T = self.device, n_text
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = {"tokens": torch.zeros((1, T), **i32),
                "bt": torch.full((1, self.max_blocks), -1, **i32),
                "start": torch.zeros((), **i32),
                "n_real": torch.zeros((), **i32)}
        prefix = self._paged_prefix() if resumed else None
        scratch = self.kv.scratch_page

        def body():
            start, n_real, bt = bufs["start"], bufs["n_real"], bufs["bt"]
            out = api.prefill(
                self.params, self.cfg, self._ctx, self.config.iso,
                {"tokens": bufs["tokens"]}, logits_mode="none",
                prefix_caches=prefix, pos_offset=start,
                block_tables=bt if resumed else None,
                prefix_lens=start.reshape(1) if resumed else None,
                valid_len=n_real, return_extras=True)
            # logits of the last REAL token (the pad tail carries garbage)
            h_last = out["hidden"].index_select(
                1, (n_real - 1).reshape(1).long())
            logits_last = emb_lib.lm_head_local(self.params["embed"],
                                                h_last)[:, 0]
            t = torch.arange(T, device=dev)
            page, off = token_page_coords(start + t, bt[0], self.ps, scratch)
            # pad-tail tokens must not scatter KV into live pages
            page = torch.where(t < n_real, page,
                               torch.full_like(page, scratch))
            # in-place scatter into every period's pool (the reference
            # rebuilds the pools with .at[].set)
            for kv_i, i in enumerate(self.kv.kv_positions):
                ex = out["extras"][i]                 # (P, 1, T, Hkv, hd)
                k_pool, v_pool = self.kv.k[kv_i], self.kv.v[kv_i]
                k_pool[:, page, off] = ex["kv_k"][:, 0].to(k_pool.dtype)
                v_pool[:, page, off] = ex["kv_v"][:, 0].to(v_pool.dtype)
            return logits_last

        self._prefill_fns[key] = StepClosure(bufs, body, self._graphed)
        return self._prefill_fns[key]

    def prefill_compile_count(self) -> int:
        """Prefill closures built so far; each is built, and on the card
        captured, once (the reference counts its jit cache entries)."""
        return len(self._prefill_fns)

    def max_prefill_compiles(self) -> Optional[int]:
        """Bound on prefill closures under bucketing: one per (bucket,
        fresh|resumed) pair, the reference's batch-1 bound.  None when
        bucketing is off (one closure per distinct grant length)."""
        if self._buckets is None:
            return None
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

    def _build_decode_fn(self, K: int, S: int, schedule: str) -> StepClosure:
        """Inputs at B = max_batch: ``toks`` (B, K), ``lengths`` (B,), the
        block tables ``bt`` (B, MB) and the decode ``mask`` (B,).  The body
        reads the pools in place, scatters the window's KV into them and
        returns the local logits (B, K, V_loc)."""
        B, dev = self.max_batch, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = {"toks": torch.zeros((B, K), **i32),
                "lengths": torch.zeros((B,), **i32),
                "bt": torch.full((B, self.max_blocks), -1, **i32),
                "mask": torch.zeros((B,), dtype=torch.bool, device=dev)}
        caches = self._paged_prefix()

        def body():
            logits, _ = api.decode_step(
                self.params, self.cfg, self._ctx, bufs["toks"], caches,
                bufs["lengths"], block_tables=bufs["bt"],
                decode_mask=bufs["mask"], kv_splits=S, schedule=schedule)
            return logits

        return StepClosure(bufs, body, self._graphed)

    # ------------------------------------------------------------------
    # step phases
    # ------------------------------------------------------------------
    def _run_grant(self, st: RequestState, start: int, n_tokens: int,
                   padded: int, last: bool) -> Optional[int]:
        """Execute one prefill grant; returns the sampled token if ``last``.
        ``padded`` (>= n_tokens) is the forward-call length; the pad tail is
        token 0, masked out of attention and scattered to the scratch page."""
        buf = np.zeros(padded, np.int32)
        buf[:n_tokens] = self._resident_tokens(st)[start:start + n_tokens]
        fn = self._get_prefill(padded, resumed=start > 0)
        host = dict(tokens=buf[None],
                    bt=self.alloc.block_table(st.request.rid,
                                              self.max_blocks)[None],
                    start=start, n_real=n_tokens)
        self._compile(fn, host)
        t0 = time.perf_counter()
        fn.stage(**host)
        logits_last = fn()
        if last:                              # the full vocab row to sample
            logits_last = all_gather_last(logits_last, self._ctx)
        self.metrics["prefill_dispatch_s"] += time.perf_counter() - t0
        synchronize(self.device)
        dur = time.perf_counter() - t0
        self.metrics["prefill_s"] += dur
        self.metrics["prefill_tokens"] += n_tokens
        self.metrics["prefill_pad_tokens"] += padded - n_tokens
        self.metrics["prefill_calls"] += 1
        logits_row = logits_last[0].float().cpu().numpy() if last else None
        return self._commit_grant_row(st, start, n_tokens, logits_row, last)

    def _commit_grant_row(self, st: RequestState, start: int, n_tokens: int,
                          logits_row, last: bool) -> Optional[int]:
        """Post-forward bookkeeping for one grant: commit tokens, advance
        prefill progress and, for a prompt-finishing grant, sample the first
        token and stamp TTFT."""
        req = st.request
        slot = st.slot
        self.alloc.commit(req.rid, n_tokens)
        st.prefilled = start + n_tokens
        self.lengths[slot] = st.prefilled
        self.metrics["prefill_grants"] += 1
        if start > 0:
            self.metrics["resumed_grants"] += 1
        if not last:
            return None
        tok = sample(logits_row[:self.cfg.vocab_size], req.sampling,
                     step=len(st.generated))
        self.metrics["prefill_samples"] += 1
        if st.t_first < 0:
            st.t_first = time.perf_counter()
            self.metrics["ttft_sum"] += st.t_first - st.t_submit
            self.metrics["ttft_n"] += 1
        st.generated.append(tok)
        self.last_tokens[slot] = tok
        st.finish_check()
        return tok

    def _finish(self, st: RequestState) -> None:
        self.metrics["completed"] += 1
        self.alloc.free(st.request.rid)
        self.scheduler.forget(st.request.rid)
        self._finished.append(st)
        self._by_rid.pop(st.request.rid, None)
        self.slots[st.slot] = None
        self.lengths[st.slot] = 0
        self.last_tokens[st.slot] = 0
        st.slot = -1

    def _prefill_phase(self, events: List[Tuple[int, int]]) -> None:
        # prefill target = sum(chunk_plan): the prompt at admission, or
        # prompt+generated after a recompute preemption
        pending = [(s.request.rid, s.prefilled, s.chunk_plan)
                   for s in self.slots
                   if s is not None and s.prefilled < sum(s.chunk_plan)]
        for g in self.scheduler.grant_prefill(pending):
            st = self._by_rid.get(g.rid)
            if st is None or st.slot < 0:
                continue                      # preempted by an earlier grant
            end = g.start + g.n_tokens
            if not self._ensure_pages(g.rid, end):
                raise RuntimeError(
                    f"page pool too small for request {g.rid}'s prefill "
                    f"chunk even after evicting; increase "
                    f"ServingConfig.num_pages")
            tok = self._run_grant(st, g.start, g.n_tokens,
                                  g.padded or g.n_tokens, g.last)
            if tok is not None:
                events.append((st.request.rid, tok))
                if st.done:
                    self._finish(st)

    def _decode_phase(self, events: List[Tuple[int, int]]) -> None:
        active = [s for s in self.slots
                  if s is not None and not s.done and s.generated
                  and s.prefilled >= sum(s.chunk_plan)]
        if not active:
            return
        # grow every decoder's capacity by one token (may evict; an evicted
        # request drops out of `active` by its slot)
        for st in active:
            if st.slot < 0:
                continue
            if not self._ensure_pages(st.request.rid,
                                      int(self.lengths[st.slot]) + 1):
                raise RuntimeError("page pool too small for a decode step; "
                                   "increase ServingConfig.num_pages")
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
        S = self._kv_splits(1)
        self.decode_splits[S] = self.decode_splits.get(S, 0) + 1
        if self._decode_schedule == "batch_split" and len(active) < 2:
            # one decoding request has no second batch half to overlap with
            schedule, fn = "sequential", self._get_fallback_decode(1, S)
        else:
            schedule, fn = self._decode_schedule, self._get_decode(1, S)
        self.decode_schedule_steps[schedule] = \
            self.decode_schedule_steps.get(schedule, 0) + 1
        host = dict(toks=self.last_tokens[:, None], lengths=self.lengths,
                    bt=bt, mask=mask)
        self._compile(fn, host)
        t0 = time.perf_counter()
        fn.stage(**host)
        logits = all_gather_last(fn(), self._ctx)
        self.metrics["decode_dispatch_s"] += time.perf_counter() - t0
        synchronize(self.device)
        dur = time.perf_counter() - t0
        logits = logits.float().cpu().numpy()
        self.metrics["decode_s"] += dur
        self.metrics["decode_calls"] += 1

        for st in active:
            i = st.slot
            tok = sample(logits[i, 0][:self.cfg.vocab_size],
                         st.request.sampling, len(st.generated))
            self.alloc.commit(st.request.rid, 1)
            self.metrics["decode_tokens"] += 1
            st.generated.append(tok)
            events.append((st.request.rid, tok))
            self.lengths[i] += 1
            self.last_tokens[i] = tok
            st.finish_check()
            if st.done:
                self._finish(st)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admission -> budgeted prefill grants ->
        batched decode.  Returns (rid, token) events."""
        events: List[Tuple[int, int]] = []
        self.metrics["steps"] += 1
        self._admit()
        self._prefill_phase(events)
        self._decode_phase(events)
        self.metrics["peak_used_pages"] = max(self.metrics["peak_used_pages"],
                                              self.alloc.used_pages)
        return events

    def run_until_complete(self, max_steps: int = 10_000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if not self.scheduler.waiting and \
                    all(s is None for s in self.slots):
                break
        return {st.request.rid: st.generated for st in self._finished}
