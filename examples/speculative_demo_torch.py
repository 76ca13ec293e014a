"""Speculative decoding demo on the PyTorch port (paper §Discussion):
self-drafted K-token verify cuts model calls per generated token while the
output stream stays exactly greedy (the port of
``examples/speculative_demo.py``).

    PYTHONPATH=src python examples/speculative_demo_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; there the dense
``Engine`` replays each prefill, decode and verify step as a CUDA graph.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import Engine, Request
from repro_torch.serving.requests import SamplingParams

CFG = ModelConfig(name="spec-demo", family="dense", num_layers=2,
                  d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                  vocab_size=64, qk_norm=True)
CONFIG = Config(model=CFG, parallel=ParallelConfig(data=1, model=1),
                iso=ISOConfig(enabled=True, num_chunks=2,
                              min_chunk_tokens=16, chunk_align=8))
SPEC_KS = (0, 3)
NEW_TOKENS = 24


def prompt() -> np.ndarray:
    """A repetitive prompt, so the bigram drafter has something to draft."""
    rng = np.random.default_rng(1)
    base = rng.integers(2, 64, 6).astype(np.int32)
    return np.tile(base, 6)


def run(params=None, device=None) -> Dict[int, Dict[str, Any]]:
    """spec_k -> the greedy tokens, ``decode_calls`` and ``spec_accepted``
    of one request on the dense ``Engine`` over ``params`` (default: the
    model from seed 0 in fp32); the streams must be identical."""
    dev = resolve_device(device)
    if params is None:
        params = api.init_params(0, CFG, tp=1, dtype=torch.float32,
                                 device=dev)
    p, out = prompt(), {}
    for spec_k in SPEC_KS:
        eng = Engine(CONFIG, params, mesh=None, max_batch=1, max_len=256,
                     bucket=16, spec_k=spec_k, device=dev)
        rid = eng.add_request(Request(
            prompt=p.copy(), sampling=SamplingParams(
                max_new_tokens=NEW_TOKENS, eos_id=-1)))
        tokens = eng.run_until_complete()[rid]
        out[spec_k] = dict(tokens=tokens,
                           decode_calls=eng.metrics["decode_calls"],
                           spec_accepted=eng.metrics["spec_accepted"])
        del eng
    plain = out[SPEC_KS[0]]["tokens"]
    for spec_k in SPEC_KS[1:]:
        assert out[spec_k]["tokens"] == plain, \
            f"speculative stream diverged at spec_k={spec_k}!"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    for spec_k, r in out.items():
        label = f"spec_k={spec_k}" if spec_k else "plain  "
        print(f"{label}: {NEW_TOKENS} tokens in {r['decode_calls']} model "
              f"calls (accepted drafts: {r['spec_accepted']})")
    print("output streams identical — speculation is exact")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
