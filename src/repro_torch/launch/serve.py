"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch qwen3-8b --preset full [--paged
[--tp N]]``.  ``--arch`` takes every config the port registers
(``configs.DENSE``: qwen3-4b/8b/32b, codeqwen1.5-7b, paper-30b, paper-70b;
the ladder twins; ``configs.ENCDEC``: whisper-medium; ``configs.MOE``:
granite-moe-3b-a800m, kimi-k2-1t-a32b; ``configs.RECURRENT``: hymba-1.5b,
xlstm-350m; ``configs.VLM``: internvl2-2b); ``--preset full``
serves it at its published widths (paper-30b fits one H100; paper-70b needs
several cards), ``--preset tiny`` a reduced twin.

Builds random weights from a seed on the device, submits a batch of
synthetic greedy requests and reports prefill and decode throughput: with
``--paged`` to the paged engine, without it to the dense-cache ``Engine``
(tp=1, bucket 32, the only engine for an audio arch).  An audio
arch's requests carry seeded frames, a vlm arch's seeded patches (its
``num_patches``), N(0, 1) x 0.1, as the stub frontends' outputs.  Runs on ``cuda`` unless ``--device cpu`` is given.  ``--tp N``
spawns N ranks (``launch/mesh.spawn``): one per card over NCCL, or on the
host over gloo under ``--device cpu``; each rank makes only its shard of the
weights, and rank 0's run is reported.

Observability and the cost model, as the reference's launcher:
``--cost-table auto|PATH`` serves with a measured cost model (``auto``: the
bundled table of this platform and tp; a failed load warns once and serves
on the static defaults), ``--autotune`` measures one first (the small
sweeps, on a throwaway engine) and serves with it, ``--trace-out T.json``
writes the engine's trace as Chrome-trace JSON (Perfetto), ``--metrics-every
N`` prints a metrics line every N engine steps, and ``--profile DIR``
records a ``torch.profiler`` trace of the run into DIR (``obs.torchprof``;
one subdirectory a rank under ``--tp``), the engine's ``engine/…`` phase
ranges in it.  A paged run's ``host:`` line splits the engines' host time
by those phases (their counters, ``prep_s`` … ``sample_s``) and gives the
mean wait before a request's first prefill call (``grant_wait_s``) and the
share of sampled rows whose token was picked on the device
(``sampled_rows_device`` of it and ``sampled_rows_host``); a dropless MoE
stack adds a ``moe:`` line (``moe_calls``, ``moe_rows`` and the device
counter ``moe_experts_hit``, read once the requests are served).

Serving modes and traffic, as the reference's launcher: ``--disagg`` serves
through a prefill engine and a decode engine with KV pages migrating
between them (``serving/disagg.py``; ``--decode-pool-pages`` sizes the
decode pool, ``--migrate-batch`` caps the requests a transfer; with
``--tp N`` the two engines are two groups of N ranks, 2 x N processes
(``launch/mesh.spawn(..., disagg=True)``), each prefill rank sending its
kv-head shard of a transfer to its peer decode rank, and the reference's
``prefill phase:``/``decode phase:`` lines come from group rank 0 of
each), ``--latency-hiding`` is taken into
``ServingConfig.latency_hiding`` and prints that it has no effect in the
port (eager program order is the schedule), ``--decode-schedule`` forces
a decode collective schedule (``ladder``/``ladder_seq`` with a ladder
arch, ``--arch ladder-qwen3-8b``),
``--probe-overlap`` times the decode schedules after the run
(``obs/overlap_probe.py``), ``--temperature`` samples instead of greedy
decoding, and ``--shared-prefix N`` opens every prompt with one N-token
system prompt.

``serve_rank`` is the per-rank body, also used by ``chip_smoke.py`` and the
tests: it serves a list of request batches ("variants") on one set of
weights, on a ``TPGroup`` rank, a ``DisaggGroup`` rank or in this process.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import Config, ISOConfig, \
    ParallelConfig, RuntimeConfig, ServingConfig, get_model_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import native
from repro_torch.core.iso import DECODE_SCHEDULES
from repro_torch.launch.mesh import DisaggGroup, disagg_devices, spawn
from repro_torch.launch.train import reduce_cfg  # noqa: F401
from repro_torch.models import api
from repro_torch.obs import torchprof, write_chrome_trace
from repro_torch.serving import Engine, PagedEngine, Request, engine
from repro_torch.serving.disagg import DisaggRouter
from repro_torch.serving.requests import SamplingParams


LATENCY_HIDING_NOTE = (
    "[latency-hiding] no effect in the port: the reference's flag sets "
    "XLA's async-collective scheduler flags, and PyTorch has no such "
    "scheduler; the port runs eagerly, so program order is the schedule "
    "(core/overlap.py): each reduce is issued the moment its partial "
    "exists and waited on after the next unit's compute")


class FiniteRows:
    """While active, every row a ``PagedEngine`` samples, greedy or on the
    host, is held to finite logits: ``PagedEngine._pick`` is wrapped to flag
    each row of the call's logits finite on the device, and
    ``PagedEngine._fetch``, after the call's fence, to read the flags of the
    rows that sample and raise on a non-finite one.  ``rows`` counts the
    rows checked."""

    def __enter__(self):
        self.real = pick, fetch = PagedEngine._pick, PagedEngine._fetch
        self.rows, flags = 0, [None]

        def checked_pick(eng, logits, rows, host_rows):
            flags[0] = torch.isfinite(
                logits[..., :eng.cfg.vocab_size]).all(-1)
            return pick(eng, logits, rows, host_rows)

        def checked_fetch(eng, picks):
            rows = picks[0]
            if not flags[0].cpu().numpy()[rows].all():
                raise FloatingPointError("non-finite logits row")
            self.rows += len(rows)
            return fetch(eng, picks)

        PagedEngine._pick, PagedEngine._fetch = checked_pick, checked_fetch
        return self

    def __exit__(self, *exc):
        PagedEngine._pick, PagedEngine._fetch = self.real
        return False


def _engines(eng) -> tuple:
    """The ``PagedEngine``s behind ``eng`` in this process: itself, or a
    router's two (under TP the one of this rank's group)."""
    if not isinstance(eng, DisaggRouter):
        return (eng,)
    return tuple(e for e in (eng.prefill, eng.decode) if e is not None)


def _drive(eng, metrics_every: int) -> Dict[int, List[int]]:
    """Step ``eng`` (an engine or a ``DisaggRouter``) to completion,
    printing a one-line metrics summary every ``metrics_every`` steps (0:
    none)."""
    if not metrics_every:
        return eng.run_until_complete()
    engines = _engines(eng)
    paged = not isinstance(eng, Engine)
    t_last, toks_last = time.perf_counter(), 0
    for step in range(1, 10_001):
        eng.step()
        waiting = engines[0].scheduler.waiting if paged else eng.pending
        done = eng.done() if isinstance(eng, DisaggRouter) else \
            not waiting and all(s is None for s in eng.slots)
        if step % metrics_every == 0 or done:
            now = time.perf_counter()
            toks = sum(e.metrics["decode_tokens"] + e.metrics["prefill_samples"]
                       for e in engines)
            rate = (toks - toks_last) / max(now - t_last, 1e-9)
            t_last, toks_last = now, toks
            active = ",".join(str(sum(s is not None for s in e.slots))
                              for e in engines)
            line = (f"[metrics] step={step} active={active} "
                    f"waiting={len(waiting)} tok/s={rate:.1f}")
            if paged:
                line += (" pool=" + ",".join(
                    f"{e.alloc.used_pages}/{e.alloc.num_pages}"
                    for e in engines)
                    + f" frag={engines[-1].alloc.fragmentation()}")
            if paged and engines[-1].spec_k:
                line += (f" accept/call="
                         f"{engines[-1].accepted_per_call():.2f}")
            if isinstance(eng, DisaggRouter):
                ms = eng.migration_stats()
                line += (f" migrated={ms['migrated_requests']} "
                         f"deferrals={ms['deferrals']}")
            print(line, flush=True)
        if done:
            break
    if isinstance(eng, DisaggRouter):
        return eng.outputs()
    return {st.request.rid: st.generated
            for e in engines for st in e._finished}


def _make_engine(config: Config, params, group, dev):
    """The variant's engine: a ``DisaggRouter`` under ``serving.disagg``
    (across the two rank groups of a ``DisaggGroup``, or in this process),
    else a ``PagedEngine``."""
    if not config.serving.disagg:
        return PagedEngine(config, params, mesh=group,
                           device=None if group is not None else dev)
    if isinstance(group, DisaggGroup):
        return DisaggRouter(config, params, mesh=group)
    if group is not None:
        raise TypeError("disaggregated serving under TP runs on the two rank "
                        "groups of a launch.mesh.DisaggGroup (spawn(..., "
                        "disagg=True)), not on one TPGroup")
    pdev, ddev, _ = disagg_devices(dev)
    return DisaggRouter(config, params, prefill_device=pdev,
                        decode_device=ddev)


def _submit(eng, v: Dict[str, Any]) -> List[int]:
    patches = v.get("patches")
    return [eng.add_request(Request(
        prompt=np.asarray(p, np.int32).copy(),
        sampling=SamplingParams(max_new_tokens=v["max_new"], eos_id=-1,
                                temperature=v.get("temperature", 0.0),
                                seed=i),
        patches=None if patches is None else patches[i]))
        for i, p in enumerate(v["prompts"])]


def serve_rank(group, config: Config,
               variants: Sequence[Dict[str, Any]],
               params_npz: Optional[str] = None, seed: int = 0,
               dtype: str = "bfloat16", device=None, autotune: bool = False,
               metrics_every: int = 0, profile_dir: Optional[str] = None
               ) -> List[Dict[str, Any]]:
    """Serve each variant on one rank of ``group`` (a ``TPGroup``, a
    ``DisaggGroup``, or None: in this process at tp=1) and return, per
    variant, the greedy tokens of its requests in submission order, the
    engine metrics, the kernel
    launch counts of that run alone, the decode steps per schedule, the
    wall time, the engine's trace events (``trace``, ``dropped``) and its
    cost model's identity (``cost_model``: platform, tp, alpha, beta, or
    None).  Under ``serving.disagg`` the variant runs on a ``DisaggRouter``:
    ``metrics`` then sums the counters of the engines in this process (both
    at tp=1, the rank's own under a ``DisaggGroup``), ``phases`` holds each
    one's by phase with its mean TPOT (``tpot_s``), and ``migration``
    holds ``migration_stats()``.

    ``autotune`` first measures a cost table with the small sweeps on a
    throwaway engine and serves every variant with it; ``metrics_every``
    prints a metrics line every that many steps on (global) rank 0;
    ``profile_dir`` records each variant's run with ``obs.torchprof``
    (under ``rank<r>`` there, r the global rank, at tp > 1).

    A variant is ``{"prompts": [int arrays], "max_new": int}`` plus optional
    ``"serving"`` / ``"iso"`` dicts of field overrides on ``config``, a
    ``"temperature"`` (request i samples with seed i), and ``"probe"``:
    keyword arguments of ``measure_overlap_efficiency``, run after the
    serving run; its dict comes back as ``probe``, and the variant's
    requests are then served again on the same engine, which must give the
    same tokens with no graph captured (the probe leaves the engine as it
    found it).  The
    weights are made once: from ``params_npz`` (a reference-layout pytree
    built at this tp, ``bridge.save_npz``), else from ``seed`` with only
    this rank's shard made.  Every sampled logits row is checked finite, and
    every page must be free after each run."""
    tp_group = group.tp_group if isinstance(group, DisaggGroup) else group
    tp = tp_group.tp if tp_group is not None else 1
    rank = tp_group.rank if tp_group is not None else 0
    dev = group.device if group is not None else resolve_device(device)
    if params_npz is not None:
        params = bridge.shard_params(bridge.load_npz(params_npz), rank, tp,
                                     device=dev)
    else:
        params = api.init_params(seed, config.model, tp=tp,
                                 dtype=getattr(torch, dtype), device=dev,
                                 rank=rank if tp_group is not None
                                 else None)
    if autotune:
        from repro_torch.perf.costmodel import CostModel
        from repro_torch.perf.costmodel import autotune as measure
        table = measure(config, params, mesh=group,
                        device=None if group is not None else dev, smoke=True,
                        log=(lambda msg: print(f"[autotune] {msg}",
                                               flush=True))
                        if rank == 0 else (lambda msg: None))
        config = dataclasses.replace(config, serving=dataclasses.replace(
            config.serving, cost_model=CostModel(table)))
    if profile_dir is not None and group is not None:
        profile_dir = os.path.join(
            profile_dir, f"rank{getattr(group, 'global_rank', rank)}")
    results = []
    with FiniteRows() as finite:
        for v in variants:
            cfg_v = dataclasses.replace(
                config,
                serving=dataclasses.replace(config.serving,
                                            **v.get("serving", {})),
                iso=dataclasses.replace(config.iso, **v.get("iso", {})))
            eng = _make_engine(cfg_v, params, group, dev)
            engines = _engines(eng)
            rids = _submit(eng, v)
            synchronize(dev)
            native.reset_launches()
            finite.rows = 0
            if profile_dir is not None:
                torchprof.start(profile_dir)
            lead = getattr(group, "global_rank", rank) == 0
            t0 = time.perf_counter()
            try:
                outs = _drive(eng, metrics_every if lead else 0)
            finally:
                wall = time.perf_counter() - t0
                profile = torchprof.stop()
            if any(e.alloc.free_pages != e.alloc.num_pages for e in engines):
                raise AssertionError(f"rank {rank}: pages leaked")
            last = engines[-1]
            cm = last.cost_model
            for e in engines:
                if isinstance(e, PagedEngine):
                    e.read_moe_hits()       # the device counter, off the path
            res = dict(
                tokens=[outs[r] for r in rids],
                metrics={k: sum(e.metrics[k] for e in engines)
                         for k in last.metrics},
                launches=dict(native.LAUNCHES),
                schedule_steps=dict(last.decode_schedule_steps),
                accepted_per_call=last.accepted_per_call(),
                decode_schedule=last._decode_schedule,
                rows_checked=finite.rows,
                wall=wall, graphs=sum(e.graphs for e in engines),
                capture_s=sum(e.capture_s for e in engines),
                trace=[ev for e in engines for ev in e.trace.events()],
                dropped=sum(e.trace.dropped for e in engines),
                profile=profile,
                migration=eng.migration_stats()
                if isinstance(eng, DisaggRouter) else None,
                phases={e.phase: dict(e.metrics, tpot_s=e.registry.histogram(
                    "tpot").mean) for e in engines},
                cost_model=None if cm is None else dict(
                    platform=cm.platform, tp=cm.tp, alpha_s=cm.alpha_s,
                    beta_s_per_byte=cm.beta_s_per_byte))
            if "probe" in v:
                graphs = eng.graphs
                res["probe"] = eng.measure_overlap_efficiency(**v["probe"])
                rids_again = _submit(eng, v)
                outs_again = eng.run_until_complete()
                again = [outs_again[r] for r in rids_again]
                if again != res["tokens"] or eng.graphs != graphs:
                    raise AssertionError(
                        f"rank {rank}: after the overlap probe the engine "
                        f"served {again} (before: {res['tokens']}) and "
                        f"captured {eng.graphs - graphs} graphs")
            results.append(res)
            del eng
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + chunked-prefill scheduler "
                         "(PagedEngine); without it the dense-cache Engine "
                         "serves (tp=1; the only engine for audio archs)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: one per card over NCCL, or "
                         "on the host over gloo with --device cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--iso-off", action="store_true")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-budget", type=int, default=64)
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "priority"])
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="run prefill grants batch-1 (one forward call per "
                         "grant) instead of packing same-bucket grants into "
                         "one batched call per scheduler tick")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify a (k+1)-token "
                         "self-drafted window per decode step (greedy only, "
                         "as every request here is)")
    ap.add_argument("--cost-table", default="", metavar="PATH|auto",
                    help="measured cost model (perf/costmodel.py): 'auto' "
                         "loads the bundled table of this platform and tp "
                         "under src/repro_torch/perf/tables/, a path that "
                         "table; the engine and scheduler then choose split "
                         "counts, grant caps, pack widths and the spec gate "
                         "from measurements (a failed load falls back to "
                         "the static defaults with one warning event)")
    ap.add_argument("--autotune", action="store_true",
                    help="before serving, measure a cost table (the small "
                         "sweeps) and serve with it (ignores --cost-table); "
                         "write a table with python -m "
                         "repro_torch.perf.costmodel --autotune instead")
    ap.add_argument("--trace-out", default=None, metavar="trace.json",
                    help="write the engine's trace (rank 0's under --tp) "
                         "as Chrome-trace JSON (open at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print a one-line metrics summary every N engine "
                         "steps (active slots, pool occupancy, tok/s, "
                         "accept rate)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of the run into DIR "
                         "(the engine's closure calls are record_function "
                         "ranges; one subdirectory a rank under --tp)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy); request i "
                         "samples with seed i")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="open every prompt with one N-token system prompt "
                         "(exercises copy-on-write prefix sharing)")
    ap.add_argument("--decode-schedule", default="auto",
                    choices=("auto",) + DECODE_SCHEDULES,
                    help="decode collective schedule (core/iso.py): auto "
                         "is batch_split under --tp when the batch allows "
                         "it, sequential otherwise; cross_block defers each "
                         "reduce to the next stage's top; ladder / "
                         "ladder_seq (deferred / immediate collectives) "
                         "need a ladder arch (--arch ladder-qwen3-8b ...), "
                         "which runs ladder by default")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: a prefill engine and a "
                         "decode engine, each request migrating by a "
                         "KV-page transfer once its prompt is resident "
                         "(serving/disagg.py; tp=1: one card twice with "
                         "one set of weights, or two cards; --tp N: two "
                         "groups of N ranks, 2N cards over NCCL, or on the "
                         "host over gloo with --device cpu)")
    ap.add_argument("--decode-pool-pages", type=int, default=0,
                    help="the decode engine's page pool under --disagg (0: "
                         "the prefill pool's size); a full decode pool "
                         "defers migration, it never drops a request")
    ap.add_argument("--migrate-batch", type=int, default=0,
                    help="requests migrated a router step at most under "
                         "--disagg (0: all that fit); a batched transfer "
                         "keeps copy-on-write sharing across the move")
    ap.add_argument("--probe-overlap", action="store_true",
                    help="after the run, time the decode collective "
                         "schedules on identical synthetic batches "
                         "(obs/overlap_probe.py); at tp=1 every efficiency "
                         "is ~0, and over gloo it times the host's "
                         "collectives: no overlap claim on one card")
    ap.add_argument("--latency-hiding", action="store_true",
                    help="the reference's flag (XLA's async-collective "
                         "scheduler flags); accepted into ServingConfig."
                         "latency_hiding and without effect here: the port "
                         "runs eagerly, so program order is the schedule")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.latency_hiding:
        print(LATENCY_HIDING_NOTE, flush=True)
    if args.probe_overlap and not args.paged:
        ap.error("--probe-overlap requires --paged")
    if (args.autotune or args.cost_table) and not args.paged:
        ap.error("--autotune/--cost-table require --paged (the dense Engine "
                 "has no cost-model decision points)")
    if args.disagg and not args.paged:
        ap.error("--disagg requires --paged (migration moves KV pages)")
    if args.decode_schedule != "auto" and not args.paged:
        ap.error("--decode-schedule requires --paged (the dense Engine "
                 "decodes on the default schedule)")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    if args.metrics_every < 0:
        ap.error("--metrics-every must be >= 0")
    if args.spec_k and args.temperature > 0:
        ap.error("--spec-k is greedy-only (needs --temperature 0)")
    if args.disagg and (args.probe_overlap or args.autotune):
        ap.error("--disagg does not combine with --probe-overlap/--autotune")
    if (args.decode_pool_pages or args.migrate_batch) and not args.disagg:
        ap.error("--decode-pool-pages/--migrate-batch require --disagg")
    if args.shared_prefix < 0:
        ap.error("--shared-prefix must be >= 0")
    device = resolve_device(args.device)

    cfg = reduce_cfg(get_model_config(args.arch), args.preset)
    if args.paged and cfg.family == "audio":
        ap.error("--paged does not support enc-dec (audio) archs: the dense "
                 "Engine serves them (drop --paged)")
    if args.tp > 1 and not args.paged:
        ap.error("--tp requires --paged (as the reference's launcher; the "
                 "dense Engine serves under TP through the API, "
                 "Engine(mesh=TPGroup))")
    if args.decode_schedule in ("ladder", "ladder_seq") and \
            cfg.residual_wiring != "ladder":
        ap.error(f"--decode-schedule {args.decode_schedule} needs a ladder "
                 f"arch (--arch ladder-...), not {args.arch}")
    iso = ISOConfig(enabled=not args.iso_off, num_chunks=args.chunks,
                    min_chunk_tokens=16, chunk_align=16)
    max_len = args.shared_prefix + args.prompt_len + args.max_new + 8
    max_len += args.spec_k + 1 if args.spec_k else 0
    # a vlm request's patches sit in the stream too (the reference's
    # launcher leaves them out, and its paged engine then refuses the
    # requests: ROADMAP queue C)
    max_len += cfg.num_patches if cfg.family == "vlm" else 0
    serving = ServingConfig(page_size=args.page_size, max_batch=args.max_batch,
                            max_len=max_len,
                            prefill_token_budget=args.prefill_budget,
                            scheduler_policy=args.policy,
                            prefix_sharing=not args.no_prefix_sharing,
                            prefill_batching=not args.no_batched_prefill,
                            spec_k=args.spec_k,
                            cost_table="" if args.autotune
                            else args.cost_table,
                            decode_schedule=args.decode_schedule,
                            disagg=args.disagg,
                            decode_pool_pages=args.decode_pool_pages,
                            migrate_batch=args.migrate_batch,
                            latency_hiding=args.latency_hiding)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=args.tp),
                    iso=iso, runtime=RuntimeConfig(mode="serve"),
                    serving=serving)
    rng = np.random.default_rng(args.seed)
    system = rng.integers(2, cfg.vocab_size,
                          args.shared_prefix).astype(np.int32)
    prompts, frames, patches = [], [], []
    for _ in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len))
        prompts.append(np.concatenate(
            [system, rng.integers(2, cfg.vocab_size, plen)]).astype(np.int32))
        # the stub frontends' outputs
        if cfg.family == "audio":
            frames.append((rng.standard_normal(
                (cfg.encoder_frames, cfg.d_model)) * 0.1).astype(np.float32))
        if cfg.family == "vlm":
            patches.append((rng.standard_normal(
                (cfg.num_patches, cfg.d_model)) * 0.1).astype(np.float32))
    if not args.paged:
        return _serve_dense(args, config, prompts, frames or None, device,
                            patches or None)
    variant = dict(prompts=prompts, max_new=args.max_new,
                   temperature=args.temperature)
    if patches:
        variant["patches"] = patches
    if args.probe_overlap:
        variant["probe"] = {}
    variants = [variant]
    opts = (args.autotune, args.metrics_every, args.profile)
    if args.autotune:
        print("[autotune] measuring (the small sweeps)...", flush=True)
    if args.tp == 1:
        res = serve_rank(None, config, variants, None, args.seed, args.dtype,
                         device, *opts)[0]
    else:
        per_rank = [r[0] for r in spawn(
            serve_rank, args.tp, args=(config, variants, None, args.seed,
                                       args.dtype, None) + opts,
            device=device.type, disagg=args.disagg)]
        if any(r["tokens"] != per_rank[0]["tokens"] for r in per_rank):
            raise AssertionError("ranks emitted different tokens")
        res = per_rank[0]
        if args.disagg:
            # group rank 0 of each: the prefill and the decode engine
            roots = (per_rank[0], per_rank[args.tp])
            res = dict(per_rank[args.tp],
                       metrics={k: sum(r["metrics"][k] for r in roots)
                                for k in res["metrics"]},
                       phases={**roots[0]["phases"], **roots[1]["phases"]},
                       trace=roots[0]["trace"] + roots[1]["trace"],
                       dropped=sum(r["dropped"] for r in roots))

    m = res["metrics"]
    dev_name = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    cm = res["cost_model"]
    if cm is not None:
        print(f"[costmodel] active: platform={cm['platform']} tp={cm['tp']} "
              f"alpha={cm['alpha_s']:.3e}s "
              f"beta={cm['beta_s_per_byte']:.3e}s/B")
    outs = res["tokens"]
    # the reference's "disagg requests=... new_tokens=..." under --disagg
    print(f"arch={cfg.name}{' disagg' if args.disagg else ''} requests="
          f"{len(outs)} new_tokens={sum(len(t) for t in outs)} "
          f"device={dev_name} tp={args.tp} iso="
          f"{'off' if args.iso_off else 'on'} decode_schedule="
          f"{res['decode_schedule']} {res['schedule_steps']} "
          f"wall={res['wall']:.2f}s graphs={res['graphs']} "
          f"capture_s={res['capture_s']:.2f}")
    print(f"prefill: {m['prefill_tokens']} tok in {m['prefill_s']:.3f}s "
          f"({m['prefill_tokens'] / max(m['prefill_s'], 1e-9):.1f} tok/s) "
          f"calls={m['prefill_calls']} resumed={m['resumed_grants']} | "
          f"decode: {m['decode_calls']} steps in {m['decode_s']:.3f}s "
          f"({1e3 * m['decode_s'] / max(m['decode_calls'], 1):.2f} ms/step) "
          f"| preemptions={m['preemptions']} completed={m['completed']}")
    launch = m["prefill_dispatch_s"] + m["decode_dispatch_s"]
    sampled = m["sampled_rows_device"] + m["sampled_rows_host"]
    print(f"host: {m['step_s']:.3f}s in {m['steps']} steps = schedule "
          f"{m['prep_s']:.3f} + capture {res['capture_s']:.3f} + launch "
          f"{launch:.3f} + wait {m['prefill_s'] + m['decode_s'] - launch:.3f}"
          f" + logits copy {m['logits_copy_s']:.3f} + sample "
          f"{m['sample_s']:.3f} | grant wait "
          f"{1e3 * m['grant_wait_s'] / max(m['grant_wait_n'], 1):.1f}ms "
          f"over {m['grant_wait_n']} requests | sampled on the device "
          f"{m['sampled_rows_device']} of {sampled} rows "
          f"({100 * m['sampled_rows_device'] / max(sampled, 1):.1f}%)")
    if "moe_calls" in m:
        print(f"moe: {m['moe_calls']} layer calls over {m['moe_rows']} rows, "
              f"{m['moe_experts_hit']} experts reached "
              f"({m['moe_experts_hit'] / max(m['moe_calls'], 1):.1f} a call)")
    print(f"sharing: prefix_shared_tokens={m['prefix_shared_tokens']} "
          f"cow_copies={m['cow_copies']} peak_used_pages="
          f"{m['peak_used_pages']} | packs: prefill_grants="
          f"{m['prefill_grants']} pad_rows={m['prefill_pad_rows']}")
    if args.spec_k:
        print(f"spec: spec_calls={m['spec_calls']} spec_tokens="
              f"{m['spec_tokens']} accepted_per_call="
              f"{res['accepted_per_call']:.3f}")
    ms = res["migration"]
    if ms is not None:
        pm, dm = res["phases"]["prefill"], res["phases"]["decode"]
        print(f"prefill phase: {pm['prefill_tokens']} tok in "
              f"{pm['prefill_s']:.2f}s calls={pm['prefill_calls']} "
              f"grants={pm['prefill_grants']} ttft="
              f"{1e3 * pm['ttft_sum'] / max(pm['ttft_n'], 1):.1f}ms")
        print(f"decode phase: {dm['decode_tokens']} tok in "
              f"{dm['decode_s']:.2f}s calls={dm['decode_calls']} "
              f"tpot={1e3 * dm['tpot_s']:.2f}ms "
              f"preemptions={dm['preemptions']}")
        print(f"migration: transfers={ms['migrations']} "
              f"requests={ms['migrated_requests']} "
              f"pages={ms['migrated_pages']} us={ms['migration_us']:.0f} "
              f"deferrals={ms['deferrals']} "
              f"bounce_backs={ms['bounce_backs']}")
    if args.probe_overlap:
        pr = res["probe"]
        exp = pr["exposed_comm_s"]
        print(f"overlap probe: efficiency={pr['overlap_efficiency']:.3f} "
              f"ladder_speedup={pr['ladder_speedup']:.3f}"
              f"{' (proxy)' if pr['ladder_proxy'] else ''} exposed_comm="
              f"{'n/a' if exp is None else f'{exp * 1e3:.2f}ms'} "
              f"(tp={pr['tp']}, B={pr['batch']}; the engine served the same "
              f"tokens after it)")
        for name, t in sorted(pr["schedules"].items()):
            print(f"  schedule {name:<12} {t * 1e3:.2f} ms/step")
    if args.autotune or args.cost_table:
        points = collections.Counter(e.payload["point"] for e in res["trace"]
                                     if e.kind == "decision")
        warns = [e.payload for e in res["trace"] if e.kind == "warning"]
        print(f"costmodel: decisions={sum(points.values())} "
              f"{dict(sorted(points.items()))} warnings={len(warns)}"
              + "".join(f" [{w['reason']}: {w['path']}]" for w in warns))
    if args.trace_out:
        n = write_chrome_trace(res["trace"], args.trace_out)
        print(f"trace: {n} events -> {args.trace_out} "
              f"(dropped={res['dropped']}; open at https://ui.perfetto.dev)")
    if args.profile:
        print(f"profile: {res['profile']}")
    for rid, toks in enumerate(outs[:3]):
        print(f"  rid {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return 0


def _serve_dense(args, config: Config, prompts, frames, device,
                 patches=None) -> int:
    """``main`` without ``--paged``: serve ``prompts`` (with ``frames`` for
    an audio arch, ``patches`` for a vlm one) on the dense ``Engine`` at
    tp=1, bucket 32, weights from
    ``--seed``; request i samples with seed i, and every sampled logits row
    is checked finite."""
    cfg = config.model
    params = api.init_params(args.seed, cfg, dtype=getattr(torch, args.dtype),
                             device=device)
    eng = Engine(config, params, max_batch=args.max_batch,
                 max_len=config.serving.max_len, bucket=32,
                 spec_k=args.spec_k, device=device)
    rids = [eng.add_request(Request(
        prompt=p, frames=None if frames is None else frames[i],
        patches=None if patches is None else patches[i],
        sampling=SamplingParams(max_new_tokens=args.max_new, eos_id=-1,
                                temperature=args.temperature, seed=i)))
        for i, p in enumerate(prompts)]
    real_sample = engine.sample

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise FloatingPointError("non-finite logits row")
        return real_sample(logits, sp, step)

    engine.sample = finite_sample
    if args.profile:
        torchprof.start(args.profile)
    t0 = time.perf_counter()
    try:
        done = _drive(eng, args.metrics_every)
    finally:
        wall = time.perf_counter() - t0
        profile = torchprof.stop()
        engine.sample = real_sample
    outs = [done[r] for r in rids]
    m = eng.metrics
    dev_name = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} engine=dense device={dev_name} tp=1 iso="
          f"{'off' if args.iso_off else 'on'} requests={len(outs)} "
          f"new_tokens={sum(len(t) for t in outs)} wall={wall:.2f}s "
          f"graphs={eng.graphs} capture_s={eng.capture_s:.2f}")
    print(f"prefill: {m['prefill_tokens']} tok in {m['prefill_s']:.3f}s "
          f"({m['prefill_tokens'] / max(m['prefill_s'], 1e-9):.1f} tok/s) "
          f"calls={m['prefill_calls']} ttft="
          f"{1e3 * m['ttft_sum'] / max(m['ttft_n'], 1):.1f}ms | decode: "
          f"{m['decode_calls']} steps in {m['decode_s']:.3f}s "
          f"({1e3 * m['decode_s'] / max(m['decode_calls'], 1):.2f} ms/step) "
          f"| completed={m['completed']}")
    if args.spec_k:
        print(f"spec: spec_calls={m['spec_calls']} spec_tokens="
              f"{m['spec_tokens']} spec_accepted={m['spec_accepted']} "
              f"decode_calls={m['decode_calls']}")
    if args.trace_out:
        n = write_chrome_trace(eng.trace.events(), args.trace_out)
        print(f"trace: {n} events -> {args.trace_out} "
              f"(dropped={eng.trace.dropped}; open at "
              f"https://ui.perfetto.dev)")
    if args.profile:
        print(f"profile: {profile}")
    for rid, toks in enumerate(outs[:3]):
        print(f"  rid {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
