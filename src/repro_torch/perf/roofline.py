"""Roofline terms from a dry-run report (port of ``repro/perf/roofline.py``).

    compute term    = flops_per_device / peak FLOP/s
    memory term     = bytes_per_device / HBM bytes/s
    collective term = collective_wire_bytes_per_device / link bytes/s

The dry run (``launch/dryrun.py``) traces ONE rank's program, so its counts
are per device already, as the reference's ``cost_analysis`` of the
SPMD-partitioned module is.  ``model_flops`` uses 6 N D for training and
2 N D for inference, with N the active parameters for MoE.

The default profile is ``"h100"`` of ``perf/model.HW_PROFILES`` (the
reference's default, ``"v5e"``, is a TPU the port has no profile of).  Its
``flops`` and ``hbm_bw`` were measured on the card (``chip_smoke.py`` phase
6); its ``link_bw`` is still NVLink 4's data-sheet figure, 450 GB/s a
direction, unmeasured until a four-card cell exists (ROADMAP queue A item
7), so the collective term is a data-sheet estimate.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config import InputShape, ModelConfig
from repro_torch.perf.model import HW_PROFILES


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per request
    return 2.0 * n_active * shape.global_batch


def roofline_terms(report: Dict[str, Any], cfg: ModelConfig,
                   shape: InputShape, hw_name: str = "h100"
                   ) -> Dict[str, Any]:
    hw = HW_PROFILES[hw_name]
    flops_dev = float(report["flops_per_device"])
    bytes_dev = float(report["bytes_per_device"])
    wire_dev = float(report["collective_wire_bytes_per_device"])
    n_dev = report["devices"]

    compute_s = flops_dev / hw.flops
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = wire_dev / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get).replace("_s", "")

    mf = model_flops(cfg, shape)
    useful = mf / max(flops_dev * n_dev, 1.0)
    return {**terms, "bottleneck": bottleneck,
            "model_flops_total": mf,
            "hlo_flops_total": flops_dev * n_dev,
            "useful_flops_ratio": useful}
