"""ISO deep-dive demo on the PyTorch port: split policies and multi-chunk
pipelines, each exact, and the analytic pipeline times (the port of
``examples/iso_prefill_demo.py``).

    PYTHONPATH=src python examples/iso_prefill_demo_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  The reference's
docstring also names overlap evidence from lowered HLO, which its code
does not compute, so neither does this script (``launch/dryrun.py``
reports a traced program's ``hideable_fraction``).  The pipeline times
come from the analytic model (``repro_torch/perf/model.py``), not from a
measurement; its ``h100`` profile's ``link_bw`` and ``comm_penalty`` are
not measured either.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ISOConfig, ModelConfig, get_model_config
from repro_torch.core.chunking import split_chunks
from repro_torch.core.overlap import AxisCtx
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.perf.model import prefill_time

CFG = ModelConfig(name="demo", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024,
                  qk_norm=True)
SEQ_LEN = 768
POLICIES = ("even", "asymmetric", "adaptive")
CHUNKS = (2, 3, 4)
# paper-70b at a 32k prefill on (profile, tp): the reference's rows, with
# the port's h100 profile (an 8-card node) where the reference has a TPU's
HW_ROWS = (("4090", 8), ("a800", 8), ("h100", 8))
MODELLED = ("h100",)
LONG_PROMPT = 32768


def iso_config(policy: str, n: int) -> ISOConfig:
    return ISOConfig(enabled=True, num_chunks=n, split_policy=policy,
                     min_chunk_tokens=32, chunk_align=32)


def pipeline_rows() -> Dict[tuple, Dict[str, Any]]:
    """(profile, tp) -> the baseline seconds, and per chunk count the
    chunk lengths, the ISO seconds and the reduction in percent."""
    p70 = get_model_config("paper-70b")
    rows = {}
    for hw, tp in HW_ROWS:
        base = prefill_time(p70, LONG_PROMPT, hw, tp, iso=False)
        row = {"base_s": base, "lengths": {}, "iso_s": {}, "reduction": {}}
        for n in CHUNKS:
            lengths = split_chunks(LONG_PROMPT,
                                   ISOConfig(enabled=True, num_chunks=n),
                                   p70, tp=tp)
            t = prefill_time(p70, LONG_PROMPT, hw, tp, lengths=lengths)
            row["lengths"][n] = lengths
            row["iso_s"][n] = t
            row["reduction"][n] = 100 * (1 - t / base)
        rows[(hw, tp)] = row
    return rows


def run(params=None, device=None,
        tokens: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Every policy x chunk count against the one-chunk prefill on
    ``params`` (default: the model from seed 0 in fp32), each within 1e-4,
    and the analytic rows.  ``tokens``: a (1, SEQ_LEN) integer array
    (default: ``api.make_inputs`` from seed 0)."""
    dev = resolve_device(device)
    if params is None:
        params = api.init_params(0, CFG, tp=1, dtype=torch.float32,
                                 device=dev)
    if tokens is None:
        batch = api.make_inputs(CFG, SEQ_LEN, 1, seed=0,
                                dtype=torch.float32, device=dev)
    else:
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                           device=dev)}
    ctx = AxisCtx()
    chunks, diffs, logits = {}, {}, {}
    with torch.no_grad():
        ref = api.prefill(params, CFG, ctx, ISOConfig(enabled=False), batch)
        for policy in POLICIES:
            for n in CHUNKS:
                out = api.prefill(params, CFG, ctx, iso_config(policy, n),
                                  batch)
                d = float((ref["logits_local"] - out["logits_local"]).abs()
                          .max())
                assert d < 1e-4, f"{policy} n={n}: logits moved by {d}"
                chunks[(policy, n)] = tuple(out["chunk_lengths"])
                diffs[(policy, n)] = d
                logits[(policy, n)] = out["logits_local"]
    return dict(chunks=chunks, max_diff=diffs, logits=logits,
                baseline_logits=ref["logits_local"], rows=pipeline_rows())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print("=== split policies (all exact) ===")
    for (policy, n), lengths in out["chunks"].items():
        print(f"  {policy:10s} n={n}: chunks={lengths} "
              f"maxdiff={out['max_diff'][(policy, n)]:.1e}")
    print(f"\n=== analytic pipeline times, paper-70b @ 32k prefill "
          f"(modelled, not measured) ===")
    for (hw, tp), row in out["rows"].items():
        cells = "  ".join(f"n={n}: -{r:.1f}%"
                          for n, r in row["reduction"].items())
        note = "  (link_bw, comm_penalty not measured)" \
            if hw in MODELLED else ""
        print(f"  {hw:5s} tp={tp:2d}  base={row['base_s'] * 1e3:7.1f}ms  "
              f"{cells}{note}")
    print("\n(multi-chunk n>2 is this repo's beyond-paper extension: deeper "
          "pipeline, smaller exposed head/tail bubbles)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
