"""Quickstart on the PyTorch port: build a small model, run baseline vs ISO
prefill, verify the paper's invariant, and show the analytic speedup the
schedule buys (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  The speedup rows come
from the analytic model (``repro_torch/perf/model.py``), not from a
measurement; its ``h100`` profile's ``link_bw`` and ``comm_penalty`` are
not measured either.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ISOConfig, ModelConfig
from repro_torch.core.overlap import AxisCtx
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.perf.model import speedup_table

CFG = ModelConfig(name="quickstart", family="dense", num_layers=4,
                  d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                  vocab_size=4096, qk_norm=True)
SEQ_LEN, BATCH = 512, 2
ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=64)
# (profile, tp, int8 wire traffic): the reference's rows, with the port's
# h100 profile where the reference prints a TPU's
TABLE = (("4090", 4, True), ("a800", 8, False), ("h100", 8, False))
MODELLED = ("h100",)
PROMPT_LENGTHS = (4096, 16384, 65536)


def run(params=None, device=None,
        tokens: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Baseline and ISO prefill of one batch on ``params`` (default: the
    model from seed 0 in fp32), and the analytic table.  ``tokens``: a
    (BATCH, SEQ_LEN) integer array (default: ``api.make_inputs`` from seed
    0)."""
    dev = resolve_device(device)
    if params is None:
        params = api.init_params(0, CFG, tp=1, dtype=torch.float32,
                                 device=dev)
    if tokens is None:
        batch = api.make_inputs(CFG, SEQ_LEN, BATCH, seed=0,
                                dtype=torch.float32, device=dev)
    else:
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                           device=dev)}
    ctx = AxisCtx()                   # single device; collectives no-op
    with torch.no_grad():
        baseline = api.prefill(params, CFG, ctx, ISOConfig(enabled=False),
                               batch)
        iso = api.prefill(params, CFG, ctx, ISO, batch)
    diff = float((baseline["logits_local"] - iso["logits_local"]).abs()
                 .max())
    assert diff < 1e-4, f"ISO changed the logits by {diff}"
    table = {(hw, tp): speedup_table(CFG, hw, tp, list(PROMPT_LENGTHS),
                                     int8_comm=int8)
             for hw, tp, int8 in TABLE}
    return dict(baseline_chunks=baseline["num_chunks"],
                num_chunks=iso["num_chunks"],
                chunk_lengths=tuple(iso["chunk_lengths"]), max_diff=diff,
                baseline_logits=baseline["logits_local"],
                logits=iso["logits_local"], table=table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"chunks: baseline={out['baseline_chunks']} "
          f"iso={out['num_chunks']} ({out['chunk_lengths']})")
    print(f"ISO exactness: max |logits_baseline - logits_iso| = "
          f"{out['max_diff']:.2e}")
    print("\nAnalytic prefill-latency reduction from the ISO schedule "
          "(paper Table 1 shape; modelled, not measured):")
    for (hw, tp), tbl in out["table"].items():
        row = "  ".join(f"{s // 1024}k: {r:5.1f}%" for s, r in tbl.items())
        note = "  (link_bw, comm_penalty not measured)" \
            if hw in MODELLED else ""
        print(f"  {hw:5s} tp={tp:2d}  {row}{note}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
