"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch qwen3-8b --preset full --paged``.

Builds random weights from a seed on the device, submits a batch of
synthetic greedy requests to the paged engine at tp=1 and reports prefill
and decode throughput.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, RuntimeConfig, ServingConfig, get_model_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import PagedEngine, Request
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
    ap.add_argument("--tp", type=int, default=1)
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
    if args.tp != 1:
        ap.error("--tp > 1 is not ported yet (ROADMAP queue A item 7)")
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
    config = Config(model=cfg, parallel=ParallelConfig(data=1, model=1),
                    iso=iso, runtime=RuntimeConfig(mode="serve"),
                    serving=serving)
    params = api.init_params(args.seed, cfg, tp=1,
                             dtype=getattr(torch, args.dtype), device=device)
    eng = PagedEngine(config, params, device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len))
        prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
        eng.add_request(Request(prompt=prompt, sampling=SamplingParams(
            max_new_tokens=args.max_new, eos_id=-1)))
    outs = eng.run_until_complete()
    wall = time.perf_counter() - t0

    m = eng.metrics
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} device={dev_name} iso="
          f"{'off' if args.iso_off else 'on'} requests={len(outs)} "
          f"new_tokens={sum(len(v) for v in outs.values())} wall={wall:.2f}s")
    print(f"prefill: {m['prefill_tokens']} tok in {m['prefill_s']:.3f}s "
          f"({m['prefill_tokens'] / max(m['prefill_s'], 1e-9):.1f} tok/s) "
          f"calls={m['prefill_calls']} resumed={m['resumed_grants']} | "
          f"decode: {m['decode_calls']} steps in {m['decode_s']:.3f}s "
          f"({1e3 * m['decode_s'] / max(m['decode_calls'], 1):.2f} ms/step) "
          f"| preemptions={m['preemptions']} completed={m['completed']}")
    for rid in sorted(outs)[:3]:
        print(f"  rid {rid}: {outs[rid][:10]}"
              f"{'...' if len(outs[rid]) > 10 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
