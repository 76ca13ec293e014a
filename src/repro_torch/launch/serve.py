"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch qwen3-8b --preset full --paged
[--tp N]``.

Builds random weights from a seed on the device, submits a batch of
synthetic greedy requests to the paged engine and reports prefill and decode
throughput.  Runs on ``cuda`` unless ``--device cpu`` is given.  ``--tp N``
spawns N ranks (``launch/mesh.spawn``): one per card over NCCL, or on the
host over gloo under ``--device cpu``; each rank makes only its shard of the
weights, and rank 0's run is reported.

``serve_rank`` is the per-rank body, also used by ``chip_smoke.py`` and the
tests: it serves a list of request batches ("variants") on one set of
weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, RuntimeConfig, ServingConfig, get_model_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import native
from repro_torch.launch.mesh import TPGroup, spawn
from repro_torch.models import api
from repro_torch.serving import PagedEngine, Request, paged_engine
from repro_torch.serving.requests import SamplingParams


def reduce_cfg(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Shrink an arch to a CPU-runnable size, keeping its family/structure
    (copy of ``repro/launch/train.reduce_cfg``)."""
    if preset == "full":
        return cfg
    layers, d, vocab = {"tiny": (2, 128, 512)}[preset]
    n_pat = len(cfg.block_pattern)
    layers = max(layers, n_pat)
    layers -= layers % n_pat
    heads = max(2, min(cfg.num_heads, d // 64))
    kv = max(1, min(cfg.num_kv_heads, heads))
    kw = dict(num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kv,
              head_dim=0, d_ff=(d * 4 if cfg.d_ff else 0),
              vocab_size=min(cfg.vocab_size, vocab),
              encoder_layers=min(cfg.encoder_layers, layers),
              encoder_frames=min(cfg.encoder_frames, 64),
              num_patches=min(cfg.num_patches, 16))
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    return dataclasses.replace(cfg, **kw)


def serve_rank(group: Optional[TPGroup], config: Config,
               variants: Sequence[Dict[str, Any]],
               params_npz: Optional[str] = None, seed: int = 0,
               dtype: str = "bfloat16", device=None) -> List[Dict[str, Any]]:
    """Serve each variant on one rank of ``group`` (or in this process at
    tp=1 when ``group`` is None) and return, per variant, the greedy tokens
    of its requests in submission order, the engine metrics, the kernel
    launch counts of that run alone, the decode steps per schedule and the
    wall time.

    A variant is ``{"prompts": [int arrays], "max_new": int}`` plus optional
    ``"serving"`` / ``"iso"`` dicts of field overrides on ``config``.  The
    weights are made once: from ``params_npz`` (a reference-layout pytree
    built at this tp, ``bridge.save_npz``), else from ``seed`` with only
    this rank's shard made.  Every sampled logits row is checked finite, and
    every page must be free after each run."""
    tp = group.tp if group is not None else 1
    rank = group.rank if group is not None else 0
    dev = group.device if group is not None else resolve_device(device)
    if params_npz is not None:
        params = bridge.shard_params(bridge.load_npz(params_npz), rank, tp,
                                     device=dev)
    else:
        params = api.init_params(seed, config.model, tp=tp,
                                 dtype=getattr(torch, dtype), device=dev,
                                 rank=rank if group is not None else None)
    real_sample = paged_engine.sample
    rows = [0]

    def finite_sample(logits, sp, step):
        if not np.isfinite(logits).all():
            raise FloatingPointError("non-finite logits row")
        rows[0] += 1
        return real_sample(logits, sp, step)

    results = []
    paged_engine.sample = finite_sample
    try:
        for v in variants:
            cfg_v = dataclasses.replace(
                config,
                serving=dataclasses.replace(config.serving,
                                            **v.get("serving", {})),
                iso=dataclasses.replace(config.iso, **v.get("iso", {})))
            eng = PagedEngine(cfg_v, params, mesh=group,
                              device=None if group is not None else dev)
            rids = [eng.add_request(Request(
                prompt=np.asarray(p, np.int32).copy(),
                sampling=SamplingParams(max_new_tokens=v["max_new"],
                                        eos_id=-1)))
                for p in v["prompts"]]
            synchronize(dev)
            native.reset_launches()
            rows[0] = 0
            t0 = time.perf_counter()
            outs = eng.run_until_complete()
            wall = time.perf_counter() - t0
            if eng.alloc.free_pages != eng.alloc.num_pages:
                raise AssertionError(f"rank {rank}: pages leaked")
            results.append(dict(
                tokens=[outs[r] for r in rids], metrics=dict(eng.metrics),
                launches=dict(native.LAUNCHES),
                schedule_steps=dict(eng.decode_schedule_steps),
                decode_schedule=eng._decode_schedule, rows_checked=rows[0],
                wall=wall))
            del eng
    finally:
        paged_engine.sample = real_sample
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + chunked-prefill scheduler (the "
                         "only engine the port has; required)")
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("the port serves through the paged engine only: pass "
                 "--paged (the dense Engine is ROADMAP queue A item 6)")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    device = resolve_device(args.device)

    cfg = reduce_cfg(get_model_config(args.arch), args.preset)
    iso = ISOConfig(enabled=not args.iso_off, num_chunks=args.chunks,
                    min_chunk_tokens=16, chunk_align=16)
    max_len = args.prompt_len + args.max_new + 8
    serving = ServingConfig(page_size=args.page_size, max_batch=args.max_batch,
                            max_len=max_len,
                            prefill_token_budget=args.prefill_budget,
                            scheduler_policy=args.policy,
                            prefix_sharing=False, prefill_batching=False)
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=args.tp),
                    iso=iso, runtime=RuntimeConfig(mode="serve"),
                    serving=serving)
    rng = np.random.default_rng(args.seed)
    prompts = []
    for _ in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len))
        prompts.append(rng.integers(2, cfg.vocab_size, plen).astype(np.int32))
    variants = [dict(prompts=prompts, max_new=args.max_new)]
    run_args = (config, variants, None, args.seed, args.dtype)
    if args.tp == 1:
        res = serve_rank(None, *run_args, device=device)[0]
    else:
        per_rank = [r[0] for r in spawn(serve_rank, args.tp, args=run_args,
                                        device=device.type)]
        if any(r["tokens"] != per_rank[0]["tokens"] for r in per_rank):
            raise AssertionError("ranks emitted different tokens")
        res = per_rank[0]

    m = res["metrics"]
    dev_name = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    outs = res["tokens"]
    print(f"arch={cfg.name} device={dev_name} tp={args.tp} iso="
          f"{'off' if args.iso_off else 'on'} decode_schedule="
          f"{res['decode_schedule']} {res['schedule_steps']} requests="
          f"{len(outs)} new_tokens={sum(len(t) for t in outs)} "
          f"wall={res['wall']:.2f}s")
    print(f"prefill: {m['prefill_tokens']} tok in {m['prefill_s']:.3f}s "
          f"({m['prefill_tokens'] / max(m['prefill_s'], 1e-9):.1f} tok/s) "
          f"calls={m['prefill_calls']} resumed={m['resumed_grants']} | "
          f"decode: {m['decode_calls']} steps in {m['decode_s']:.3f}s "
          f"({1e3 * m['decode_s'] / max(m['decode_calls'], 1):.2f} ms/step) "
          f"| preemptions={m['preemptions']} completed={m['completed']}")
    for rid, toks in enumerate(outs[:3]):
        print(f"  rid {rid}: {toks[:10]}{'...' if len(toks) > 10 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
