"""Dense-cache serving engine: continuous batching with ISO prefill (port of
``repro/serving/engine.py``).

The paper's serving shape: prefill runs per request (batch 1, Table 1's
setting) under the ISO schedule; decode runs batched over all slots with the
plain schedule.  Each slot owns a dense padded cache row of ``max_len``
positions (``models/api.init_caches``): ``k``/``v`` and a ``pos`` array of
each slot's absolute position (-1 = empty), which decode masks by.  Prompt
lengths are bucketed (``bucket``); the padded tail's cache positions are
scrubbed to -1 when the prefill's caches are written into the slot (inside
the prefill closure).  It is the only engine that serves the encoder-decoder
family (whisper): a request's ``frames`` ride into its prefill, and its
cross K/V into the slot's ``cross_k``/``cross_v``.  A VLM request's
``patches`` ride into its prefill ahead of its text, and the slot's length
counts them.  A recurrent stack
(hymba's ``hybrid``, xLSTM's ``mlstm``/``slstm``) keeps each slot's state
(``ssm``/``mlstm``/``slstm``) beside the ring caches: a prefill writes the
state after the whole BUCKET-PADDED prompt into the slot (the pad tokens
advance it, as the reference's do), and every decode step advances every
slot's state, as the reference's wholesale replace (a slot's state is
rewritten by the prefill of the next request it takes).

Speculative decoding (``spec_k``): greedy-only self-drafting on attention
stacks, as the reference (a recurrent stack or whisper gets ``spec_k`` 0:
a rejected verify token would have advanced the state); a verify step runs
a (spec_k+1)-token window through the same dense decode and scrubs the
rejected positions (``pos >= confirmed length`` -> -1).

Observability as the reference's (and ``PagedEngine``'s): the same counter
names (plus the dense-only ``spec_accepted``), the ``ttft`` histogram,
the trace events admit, prefill_call, sample,
decode_call, accept and finish, and ``obs.torchprof`` ranges named
``prefill/T=…`` and ``decode/K=…``.  ``prefill_s``/``decode_s`` are fenced
(the card has finished the step, caches included); the ``*_dispatch_s``
pair is the host time until the calls return.

Compiled closures.  As the reference jits one function per key, the engine
builds one ``StepClosure`` (serving/closures.py, shared with
``PagedEngine``) per key: a prefill closure per (bucket, frames?, patch
count), the reference's ``(bucket, frames?, patches?)`` key with the
patches' count for its flag (a static buffer has one shape), one decode
closure (K = 1) and one verify closure per window K = spec_k + 1.  A
prefill closure's inputs are the padded tokens, the frames or patches, and
0-d device buffers of the slot and the effective prompt length; its body
writes the batch-1 caches into the slot IN PLACE (``index_copy_`` along the
batch dimension at the slot's index: every ring leaf, every field of a
recurrent state, whisper's cross K/V; the padded tail's ``pos`` scrubbed to
-1) and gathers the one logits row it samples on the device.  A decode or
verify closure takes the (max_batch, K) tokens and the lengths; the ring
caches are written in place (``core/iso._insert_ring``) and every slot's
recurrent state advanced in place.  On the card at tp=1 each closure is
captured once in a ``torch.cuda.CUDAGraph`` (every graph drawing on one
shared memory pool) and each call is one replay; ``cuda_graphs=False``
runs the same bodies eagerly, as do the CPU and a TP engine (its
collectives go through gloo on the host, which a graph cannot hold).  A
failed capture or replay raises; nothing falls back to the eager body.  The
verify step's scrub of rejected positions runs eagerly after the replay,
as the reference runs it outside its jits.  A prefill copies one logits
row to the host, the row it samples (the reference copies them all).

Tensor parallelism: ``mesh=`` takes this rank's ``launch.mesh.TPGroup``, as
``PagedEngine``'s does; ``params`` are then the rank's shard
(``bridge.shard_params`` or ``api.init_params(..., rank=)``), the ring
caches hold its share of the kv heads (``api.init_caches(..., local=True)``)
and prefill and decode go through ``launch/runner``, the reference's
distributed boundary.  Every rank runs this same host loop on the same
requests; the vocab-sharded logits are gathered (``runner.gather_logits``)
before sampling, so every rank samples the same token over the real vocab.
Decode runs the reference's sequential schedule; speculation is as at tp=1.
A group with data ranks is refused: the caches and slots hold every row.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ATTN_KINDS, Config, padded_vocab
from repro_torch.device import resolve_device, synchronize
from repro_torch.core.iso import ring_window
from repro_torch.launch import runner
from repro_torch.launch.mesh import TPGroup
from repro_torch.models import api
from repro_torch.models.blocks import STATE_KEYS
from repro_torch.models.decoder import check_supported
from repro_torch.obs import torchprof
from repro_torch.obs.registry import MetricsRegistry, TTFT_BUCKETS_S
from repro_torch.obs.trace import TraceRing
from repro_torch.serving.closures import StepClosure
from repro_torch.serving.requests import Request, RequestState
from repro_torch.serving.sampler import sample
from repro_torch.serving.speculative import BigramDraft, accept_greedy


def _n_patches(req: Request) -> int:
    return req.patches.shape[0] if req.patches is not None else 0


def _bucket(n: int, b: int) -> int:
    return max(b, ((n + b - 1) // b) * b)


def _first_leaf(tree) -> torch.Tensor:
    """The reference's ``tree_leaves(params)[0]``: keys in sorted order."""
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


class Engine:
    """``device`` defaults to ``cuda`` (raises without it), or is the TP
    group's (``mesh=``); the params must live there
    (``api.init_params(..., device=)``).  ``cuda_graphs`` (default True)
    captures each closure in a CUDA graph on the card at tp=1; False runs
    the closures eagerly (A/B runs).  CPU and TP engines always run them
    eagerly (module doc)."""

    def __init__(self, config: Config, params, mesh: TPGroup = None, *,
                 max_batch: int = 4, max_len: int = 512, bucket: int = 64,
                 spec_k: int = 0, observability: bool = True, device=None,
                 cuda_graphs: bool = True):
        if mesh is not None and not isinstance(mesh, TPGroup):
            raise TypeError(f"mesh must be a launch.mesh.TPGroup, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and mesh.dp > 1:
            raise ValueError(f"the dense Engine serves tensor parallelism "
                             f"only: its caches and slots hold every row, "
                             f"and this rank group has {mesh.dp} data ranks; "
                             f"give each data replica its own TP group")
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the TP group's "
                             f"{mesh.device}")
        check_supported(config.model)
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        leaf = _first_leaf(params)
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}; make them with "
                             f"api.init_params(..., device=...)")
        self.config = config
        self.cfg = config.model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.bucket = bucket
        self.tp = mesh.tp if mesh is not None else 1
        table = params.get("decoder", params)["embed"]["table"]
        if table.shape[0] * self.tp != padded_vocab(self.cfg, self.tp):
            raise ValueError(f"embedding shard of {table.shape[0]} rows is "
                             f"not 1/{self.tp} of the tp={self.tp} padded "
                             f"vocab; pass this rank's shard of params built "
                             f"at tp={self.tp}")
        self._prefill_fn = runner.make_prefill_fn(
            config, mesh, logits_mode="all", return_cache=True,
            cache_len=max_len, global_batch=1)
        self._decode_fn = runner.make_decode_fn(config, mesh,
                                                global_batch=max_batch)
        self._ctx = self._decode_fn.ctx
        # the cache dtype follows the params; this rank's kv heads
        self.caches = api.init_caches(self.cfg, max_batch, max_len, self.tp,
                                      dtype=leaf.dtype, device=self.device,
                                      local=True)
        # the recurrent states a decode step advances in place: a capture's
        # warm-up puts them back
        self._state_tensors = tuple(t for c in self.caches
                                    for sk in STATE_KEYS if sk in c
                                    for t in c[sk])
        # compiled closures, keyed as the reference's jits: prefill
        # (bucket, frames?, n_patches); decode and verify by window K (1:
        # the plain decode, spec_k + 1: the verify window)
        self._prefill_fns: Dict[Tuple[int, bool, int], StepClosure] = {}
        self._decode_fns: Dict[int, StepClosure] = {}
        self._graphed = cuda_graphs and mesh is None \
            and self.device.type == "cuda"
        # one memory pool for every graph, and one side stream for every
        # capture's warm-up
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self._graphed else None
        self._capture_stream = torch.cuda.Stream(self.device) \
            if self._graphed else None
        # CUDA graphs captured, and the seconds their captures took
        self.graphs = 0
        self.capture_s = 0.0
        self.slots: List[Optional[RequestState]] = [None] * max_batch
        self.lengths = np.zeros(max_batch, np.int64)
        self.last_tokens = np.zeros(max_batch, np.int64)
        self.pending: List[Request] = []
        self._finished: List[RequestState] = []
        # speculative decoding: attention stacks only, as the paged engine;
        # whisper's decode (and a recurrent stack) falls back to plain
        self.spec_k = spec_k if all(k in ATTN_KINDS
                                    for k in self.cfg.block_pattern) else 0
        self._drafts: List[Optional[BigramDraft]] = [None] * max_batch
        # observability: the paged engine's counter names (plus the
        # dense-only spec_accepted) so the two engines diff key for key;
        # preemptions stays 0, the dense engine never evicts
        self.registry = MetricsRegistry()
        self.trace = TraceRing(enabled=observability)
        self.registry.histogram("ttft", TTFT_BUCKETS_S)
        self.registry.counters((
            "prefill_s", "decode_s", "prefill_dispatch_s",
            "decode_dispatch_s", "prefill_tokens", "decode_tokens",
            "completed", "decode_calls", "prefill_calls", "steps",
            "preemptions", "ttft_sum", "ttft_n", "spec_accepted",
            "spec_calls", "spec_tokens", "prefill_samples"))
        self.metrics = self.registry.view()
        self._t_submit: Dict[int, float] = {}

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        if req.patches is not None and \
                tuple(req.patches.shape[1:]) != (self.cfg.d_model,):
            raise ValueError(f"request {req.rid}: patches of shape "
                             f"{tuple(req.patches.shape)}, want (n, "
                             f"{self.cfg.d_model})")
        if (req.frames is not None) != (self.cfg.family == "audio"):
            raise ValueError(f"request {req.rid}: frames "
                             f"{'missing' if req.frames is None else 'given'}"
                             f" for a {self.cfg.family} model")
        want = (self.cfg.encoder_frames, self.cfg.d_model)
        if req.frames is not None and tuple(req.frames.shape) != want:
            raise ValueError(f"request {req.rid}: frames of shape "
                             f"{tuple(req.frames.shape)}, want {want}")
        if req.frames is not None and np.asarray(req.frames).dtype not in (
                np.float32, np.float64):
            # float64 is cast, as jnp.asarray does; the closure's frames
            # buffer is float32
            raise ValueError(f"request {req.rid}: frames of dtype "
                             f"{np.asarray(req.frames).dtype}, want float32")
        eff = len(req.prompt) + _n_patches(req)
        if eff + req.sampling.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid}: {eff} prompt + "
                             f"{req.sampling.max_new_tokens} new tokens "
                             f"exceeds max_len={self.max_len}")
        self._t_submit[req.rid] = time.perf_counter()
        self.pending.append(req)
        return req.rid

    def _start_request(self, req: Request, slot: int) -> None:
        plen = len(req.prompt)
        blen = min(_bucket(plen, self.bucket), self.max_len)
        toks = np.zeros((1, blen), np.int32)
        toks[0, :plen] = req.prompt
        # the prompt's length in the decoder stream (patches come first)
        eff_plen = plen + _n_patches(req)
        fn = self._get_prefill(blen, req.frames is not None, _n_patches(req))
        host = dict(tokens=toks, slot=slot, n_real=eff_plen)
        if req.frames is not None:
            host["frames"] = np.asarray(req.frames, np.float32)[None]
        if req.patches is not None:
            host["patches"] = np.asarray(req.patches, np.float32)[None]
        self._compile(fn, host)

        t0 = time.perf_counter()
        with torchprof.annotate(f"prefill/T={blen}"):
            fn.stage(**host)
            # the one row to sample, taken (and gathered) on the device
            row = runner.gather_logits(fn()[None], self._ctx)[0]
        self.metrics["prefill_dispatch_s"] += time.perf_counter() - t0
        # fence the whole step, the caches' write included
        synchronize(self.device)
        dur = time.perf_counter() - t0
        self.metrics["prefill_s"] += dur
        self.metrics["prefill_tokens"] += plen
        self.metrics["prefill_calls"] += 1
        self.trace.emit("prefill_call", rid=req.rid, slot=slot, dur=dur,
                        ts=t0, tokens=plen, pad=blen - plen, rows=1)
        logits = row.float().cpu().numpy()
        # sample over the REAL vocab only (the table is padded for TP)
        first = sample(logits[:self.cfg.vocab_size], req.sampling, step=0)
        self.metrics["prefill_samples"] += 1
        ttft = time.perf_counter() - self._t_submit.pop(req.rid,
                                                        time.perf_counter())
        self.metrics["ttft_sum"] += ttft
        self.metrics["ttft_n"] += 1
        self.registry.histogram("ttft").observe(ttft)
        self.trace.emit("sample", rid=req.rid, slot=slot, first=True)

        st = RequestState(request=req, slot=slot, prompt_len=eff_plen)
        st.generated.append(first)
        st.finish_check()
        self.lengths[slot] = eff_plen
        self.last_tokens[slot] = first
        if self.spec_k:
            d = BigramDraft()
            d.observe([int(t) for t in req.prompt] + [first])
            self._drafts[slot] = d
        if st.done:
            self.metrics["completed"] += 1
            self.trace.emit("finish", rid=req.rid, slot=slot)
            self._finished.append(st)
            self._clear_slot(slot)
        else:
            self.slots[slot] = st

    def _clear_slot(self, slot: int) -> None:
        """Drop ALL per-slot state when a request leaves: a stale length
        would hold the speculative gate (``max(lengths)``) shut for the
        rest of the batch's lifetime."""
        self.slots[slot] = None
        self.lengths[slot] = 0
        self.last_tokens[slot] = 0
        self._drafts[slot] = None

    # ------------------------------------------------------------------
    # compiled closures
    # ------------------------------------------------------------------
    def _compile(self, fn: StepClosure, host: Dict) -> None:
        """Capture ``fn`` on its first call, over the call's ``host`` inputs,
        outside the timed window of the call (which stages them again)."""
        if fn.graphed and fn.graph is None:
            fn.stage(**host)
            restore = self._save_window(fn)
            self.capture_s += fn.capture(self._capture_stream,
                                         self._graph_pool)
            restore()
            self.graphs += 1

    def _save_window(self, fn: StepClosure):
        """Save what the warm-up of a capture of ``fn`` (one run of its body
        over the staged inputs) writes and the replay after it would read:
        a decode or verify closure's window in every ring (k, v and pos at
        ``ring_window``), which the replay would attend as already cached.
        Returns the call that puts it back.  A prefill closure reads no
        cache, and the recurrent states are the closure's ``mutates``."""
        saved = []
        if "lengths" in fn.inputs:
            K = fn.inputs["tokens"].shape[1]
            for c in self.caches:
                if "k" in c:
                    rows, cols = ring_window(fn.inputs["lengths"],
                                             c["k"].shape[2], K, self.device)
                    saved += [(t, rows, cols, t[:, rows, cols].clone())
                              for t in (c["k"], c["v"], c["pos"])]

        def restore():
            for t, rows, cols, old in saved:
                t[:, rows, cols] = old

        return restore

    def _get_prefill(self, blen: int, frames: bool,
                     n_patches: int) -> StepClosure:
        """Prefill closure of a bucket length ``blen``, with ``frames``
        (audio) or ``n_patches`` patches ahead of the text (vlm).  Inputs:
        ``tokens`` (1, blen), the 0-d ``slot`` and ``n_real`` (the prompt's
        length in the decoder stream, patches counted), ``frames`` (1, F,
        D) and ``patches`` (1, n_patches, D), both float32.  The body runs
        the batch-1 prefill (all logits and the caches, as the reference),
        copies every cache leaf (each field of a recurrent state, cross K/V
        cast to the cache dtype) into the slot in place, positions
        ``>= n_real`` scrubbed to -1, and returns the local logits row of
        position ``n_real - 1`` (V_loc,).  The body holds the engine's
        params and caches, never the engine."""
        key = (blen, frames, n_patches)
        if key in self._prefill_fns:
            return self._prefill_fns[key]
        dev, D = self.device, self.cfg.d_model
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        bufs = {"tokens": torch.zeros((1, blen), **i32),
                "slot": torch.zeros((), **i32),
                "n_real": torch.zeros((), **i32)}
        if frames:
            bufs["frames"] = torch.zeros((1, self.cfg.encoder_frames, D),
                                         **f32)
        if n_patches:
            bufs["patches"] = torch.zeros((1, n_patches, D), **f32)
        params, caches, prefill_fn = self.params, self.caches, \
            self._prefill_fn

        def body():
            slot = bufs["slot"].reshape(1).long()
            n_real = bufs["n_real"]
            out = prefill_fn(params, {k: bufs[k] for k in
                                      ("tokens", "frames", "patches")
                                      if k in bufs})
            for big, small in zip(caches, out["caches"]):
                for name, t in small.items():
                    if isinstance(t, tuple):          # a recurrent state
                        for b, s in zip(big[name], t):
                            b.index_copy_(1, slot, s.to(b.dtype))
                    elif t.ndim >= 2 and t.shape[1] == 1:
                        if name == "pos":         # the padded tail: empty
                            t = t.masked_fill(t >= n_real, -1)
                        big[name].index_copy_(1, slot,
                                              t.to(big[name].dtype))
            last = (n_real - 1).reshape(1).long()
            return out["logits_local"][0].index_select(0, last)[0]

        self._prefill_fns[key] = StepClosure(bufs, body, self._graphed)
        return self._prefill_fns[key]

    def _get_decode(self, K: int) -> StepClosure:
        """Decode closure of a K-token window over every slot (K = 1 the
        plain decode, K = spec_k + 1 a verify window).  Inputs: ``tokens``
        (max_batch, K) and ``lengths`` (max_batch,).  The body writes the
        window's KV into the ring caches and advances every slot's
        recurrent state, both in place, and returns the local logits (B, K,
        V_loc)."""
        if K not in self._decode_fns:
            i32 = dict(dtype=torch.int32, device=self.device)
            bufs = {"tokens": torch.zeros((self.max_batch, K), **i32),
                    "lengths": torch.zeros((self.max_batch,), **i32)}
            params, caches, decode_fn = self.params, self.caches, \
                self._decode_fn

            def body():
                logits, _ = decode_fn(params, bufs["tokens"], caches,
                                      bufs["lengths"])
                return logits

            self._decode_fns[K] = StepClosure(bufs, body, self._graphed,
                                              self._state_tensors)
        return self._decode_fns[K]

    # ------------------------------------------------------------------
    def _decode(self, toks: np.ndarray, label: str):
        """One decode call over every slot: stage the tokens and lengths
        into the window's closure, call it (caches updated in place), fence,
        and return the logits (B, K, V) on the host and the fenced
        seconds."""
        fn = self._get_decode(toks.shape[1])
        host = dict(tokens=toks, lengths=self.lengths.astype(np.int32))
        self._compile(fn, host)
        t0 = time.perf_counter()
        with torchprof.annotate(label):
            fn.stage(**host)
            logits = runner.gather_logits(fn(), self._ctx)
        self.metrics["decode_dispatch_s"] += time.perf_counter() - t0
        synchronize(self.device)
        dur = time.perf_counter() - t0
        self.metrics["decode_s"] += dur
        self.metrics["decode_calls"] += 1
        return logits[..., :self.cfg.vocab_size].float().cpu().numpy(), dur, \
            t0

    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration; returns (rid, token) events."""
        events: List[Tuple[int, int]] = []
        self.metrics["steps"] += 1
        # admission: start pending requests on free slots (prefill, batch 1)
        for i in range(self.max_batch):
            if self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                self.trace.emit("admit", rid=req.rid, slot=i)
                self._start_request(req, i)
                st = [s for s in ([self.slots[i]] + self._finished)
                      if s and s.request.rid == req.rid]
                if st:
                    events.append((req.rid, st[0].generated[-1]))

        active = [s for s in self.slots if s is not None]
        if not active:
            return events
        if self.spec_k and all(s.request.sampling.temperature <= 0
                               for s in active) and \
                max(self.lengths) + self.spec_k + 1 <= self.max_len:
            return events + self._step_speculative(active)

        logits, dur, t0 = self._decode(
            self.last_tokens[:, None].astype(np.int32), "decode/K=1")
        self.trace.emit("decode_call", dur=dur, ts=t0, k=1,
                        active=len(active))
        for st in active:
            i = st.slot
            tok = sample(logits[i, 0], st.request.sampling,
                         len(st.generated))
            st.generated.append(tok)
            self.lengths[i] += 1
            self.last_tokens[i] = tok
            if self._drafts[i] is not None:
                # plain steps (gate closed) still feed the draft, or it
                # re-engages with a stale anchor
                self._drafts[i].observe([tok])
            self.metrics["decode_tokens"] += 1
            self.trace.emit("accept", rid=st.request.rid, slot=i, n=1,
                            spec=False)
            events.append((st.request.rid, tok))
            st.finish_check()
            if st.done:
                self.metrics["completed"] += 1
                self.trace.emit("finish", rid=st.request.rid, slot=i)
                self._finished.append(st)
                self._clear_slot(i)
        return events

    # ------------------------------------------------------------------
    def _step_speculative(self, active) -> List[Tuple[int, int]]:
        """Verify a K-token window [last, d1..d_{K-1}] per slot; accept the
        longest greedy-matching prefix, then scrub the rejected positions
        from every slot's cache."""
        K = self.spec_k + 1
        toks = np.zeros((self.max_batch, K), np.int32)
        drafts: Dict[int, List[int]] = {}
        for st in active:
            i = st.slot
            d = self._drafts[i].draft(self.spec_k)
            drafts[i] = d
            toks[i] = [self.last_tokens[i]] + d
        logits, dur, t0 = self._decode(toks, f"decode/K={K}")
        self.metrics["spec_calls"] += 1
        self.trace.emit("decode_call", dur=dur, ts=t0, k=K,
                        active=len(active))

        events: List[Tuple[int, int]] = []
        new_lens = self.lengths.copy()
        for st in active:
            i = st.slot
            argmaxes = logits[i].argmax(axis=-1)
            budget = st.request.sampling.max_new_tokens - len(st.generated)
            acc = accept_greedy(drafts[i], argmaxes)[:max(budget, 1)]
            self.metrics["spec_accepted"] += len(acc) - 1
            self.metrics["spec_tokens"] += len(acc)
            self.metrics["decode_tokens"] += len(acc)
            self.trace.emit("accept", rid=st.request.rid, slot=i, n=len(acc),
                            spec=True)
            for tok in acc:
                st.generated.append(int(tok))
                events.append((st.request.rid, int(tok)))
            self._drafts[i].observe(acc)
            new_lens[i] = self.lengths[i] + len(acc)
            self.last_tokens[i] = acc[-1]
            st.finish_check()
            if st.done:
                self.metrics["completed"] += 1
                self.trace.emit("finish", rid=st.request.rid, slot=i)
                self._finished.append(st)
                self._clear_slot(i)
                # the slot's whole pos is scrubbed below, and the gate
                # stops reading its length
                new_lens[i] = 0
        # scrub the cache slots of rejected draft tokens
        nl = torch.from_numpy(new_lens.astype(np.int32)).to(self.device)
        for c in self.caches:
            c["pos"].masked_fill_(c["pos"] >= nl[None, :, None], -1)
        self.lengths = new_lens
        return events

    def run_until_complete(self, max_steps: int = 10_000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if not self.pending and all(s is None for s in self.slots):
                break
        return {st.request.rid: st.generated for st in self._finished}
