"""Analytic performance model of the ISO pipeline (copy of
``repro/perf/model.py``): an event-driven simulation of two resources, one
compute engine (the SMs) and one communication channel (NVLink / PCIe).
The baseline serialises them; ISO pipelines chunks so the channel works while
the other chunk computes.  It carries the paper's frictions: the NCCL "SM
steal" compute penalty while a collective is in flight, and optional int8
wire traffic (the paper's 4090 path).

The ``auto`` split policy (``core/chunking.auto_split``) optimises over it.
Every function does the reference's floating-point operations in the
reference's order, so ``auto_split`` breaks ties (at tp=1 every candidate
split costs the same in exact arithmetic) the way the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.config import ModelConfig


@dataclass(frozen=True)
class HW:
    name: str
    flops: float                 # effective matmul FLOP/s per device
    hbm_bw: float                # bytes/s per device
    link_bw: float               # effective all-reduce wire bytes/s per device
    comm_penalty: float = 0.0    # compute slowdown while a collective is in flight
    comm_dtype_bytes: float = 2.0


DEFAULT_HW = "h100"

HW_PROFILES: Dict[str, HW] = {
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit, measured by
    # chip_smoke.py phase 6 (its `[time] h100 profile` line): flops, a bf16
    # torch.matmul at paper-30b's ISO-chunk MLP shape, (512, 6656) @
    # (6656, 17920), 0.16847 ms; hbm_bw, bytes read plus written by a
    # device-to-device copy of 2 GiB, 1.76044 ms.  NOT measured, until a
    # four-card cell exists: link_bw, NVLink 4's 450 GB/s a direction from
    # the data sheet, and comm_penalty, the reference's A800 figure for the
    # same NCCL SM steal.
    "h100": HW("h100", flops=7.249828e14, hbm_bw=2.439710e12, link_bw=450e9,
               comm_penalty=0.18),
    # the paper's platforms (the reference's effective numbers, tuned to the
    # paper's observed ratios)
    "a800": HW("a800", flops=250e12, hbm_bw=2039e9, link_bw=160e9,
               comm_penalty=0.18),
    # link_bw calibrated so the 30b/tp4/8k comm share is ~75% (paper Fig 2a)
    "4090": HW("4090", flops=220e12, hbm_bw=1008e9, link_bw=10e9,
               comm_penalty=0.0),
}


# ---------------------------------------------------------------------------
# per-chunk stage costs
# ---------------------------------------------------------------------------

def layer_costs(cfg: ModelConfig, a: int, b: int, hw: HW, tp: int,
                int8_comm: bool = False) -> Dict[str, float]:
    """Times for one layer's stages on the chunk spanning tokens [a, b).

    Returns {"attn": s, "mlp": s, "comm": s} (comm = ONE all-reduce of the
    chunk's activations).
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s_c = b - a
    proj = 2.0 * s_c * d * hd * (2 * hq + 2 * hkv)           # qkv + o
    attn_quad = 2.0 * 2.0 * hq * hd * (b * b - a * a) / 2.0  # scores + pv
    if cfg.sliding_window:
        w = cfg.sliding_window
        pairs = sum(min(t + 1, w) for t in (a, b - 1)) / 2.0 * s_c
        attn_quad = 2.0 * 2.0 * hq * hd * pairs
    if cfg.moe is not None:
        ff_flops = 2.0 * 3.0 * d * cfg.moe.d_ff_expert * cfg.moe.top_k * s_c
        ff_flops += 2.0 * 3.0 * d * cfg.moe.shared_expert_d_ff * s_c
        ff_flops += 2.0 * d * cfg.moe.num_experts * s_c      # router
    else:
        ff_flops = 2.0 * 3.0 * d * cfg.d_ff * s_c
    t_attn = (proj + attn_quad) / tp / hw.flops
    t_mlp = ff_flops / tp / hw.flops
    wire = 2.0 * (tp - 1) / tp * s_c * d * \
        (1.0 if int8_comm else hw.comm_dtype_bytes)
    t_comm = wire / hw.link_bw
    return {"attn": t_attn, "mlp": t_mlp, "comm": t_comm}


# ---------------------------------------------------------------------------
# event-driven pipeline simulation
# ---------------------------------------------------------------------------

def simulate_pipeline(units: List[Tuple[float, int]], comm_times: List[float],
                      penalty: float) -> float:
    """units: [(compute_time, chunk_id)] in ISO order; after unit i its collective
    (comm_times[i]) is enqueued on the serial channel.  A unit may start only when
    the previous collective OF ITS OWN CHUNK's previous stage has completed —
    which in the ISO order is comm[i - n_chunks]: the interleave distance is the
    number of chunks.  Baseline (1 chunk) degenerates to full serialisation.

    ``penalty`` models the paper's observation that an in-flight NCCL collective
    steals SMs: compute is slowed by ``penalty`` only DURING comm/compute
    overlap.  Implemented as a two-pass approximation: simulate, measure the
    total overlapped duration, charge ``penalty x overlap`` on top.
    """
    n = len(units)
    comp_free = 0.0
    comm_free = 0.0
    comm_done = [0.0] * n
    comp_iv: List[Tuple[float, float]] = []
    comm_iv: List[Tuple[float, float]] = []
    n_chunks = len({c for _, c in units})
    for i, (t, _c) in enumerate(units):
        dep = comm_done[i - n_chunks] if i - n_chunks >= 0 else 0.0
        start = max(comp_free, dep)
        comp_free = start + t
        comp_iv.append((start, comp_free))
        c_start = max(comm_free, comp_free)
        comm_done[i] = c_start + comm_times[i]
        comm_iv.append((c_start, comm_done[i]))
        comm_free = comm_done[i]
    makespan = max(comp_free, comm_free)
    if penalty:
        overlap = 0.0
        for cs, ce in comp_iv:
            for ms, me in comm_iv:
                lo, hi = max(cs, ms), min(ce, me)
                if hi > lo:
                    overlap += hi - lo
        makespan += penalty * overlap
    return makespan


def _stage_units(cfg: ModelConfig, lengths: Sequence[int], hw: HW, tp: int,
                 int8_comm: bool):
    """Build the per-layer (unit, comm) lists in ISO order."""
    bounds = []
    acc = 0
    for l in lengths:
        bounds.append((acc, acc + l))
        acc += l
    units, comms = [], []
    for stage in ("attn", "mlp"):
        for ci, (a, b) in enumerate(bounds):
            c = layer_costs(cfg, a, b, hw, tp, int8_comm)
            units.append((c[stage], ci))
            comms.append(c["comm"])
    return units, comms


def prefill_time(cfg: ModelConfig, seq_len: int, hw_name: str, tp: int, *,
                 lengths: Sequence[int] = None, int8_comm: bool = False,
                 iso: bool = True) -> float:
    """Total prefill latency for one request (batch 1, the paper's metric)."""
    hw = HW_PROFILES[hw_name]
    if not iso or lengths is None or len(lengths) <= 1:
        c = layer_costs(cfg, 0, seq_len, hw, tp, int8_comm)
        per_layer = c["attn"] + c["mlp"] + 2 * c["comm"]
        return cfg.num_layers * per_layer
    units, comms = _stage_units(cfg, lengths, hw, tp, int8_comm)
    # steady state: the pipeline wraps across layers, so simulate L layers' units
    all_units = units * cfg.num_layers
    all_comms = comms * cfg.num_layers
    return simulate_pipeline(all_units, all_comms, hw.comm_penalty)


def simulate_iso_fractions(cfg: ModelConfig, lengths: Sequence[int],
                           hw_name: str = DEFAULT_HW, tp: int = 1) -> float:
    seq = sum(lengths)
    return prefill_time(cfg, seq, hw_name, tp, lengths=lengths)


def speedup_table(cfg: ModelConfig, hw_name: str, tp: int,
                  prompt_lengths: Sequence[int], *, int8_comm: bool = False,
                  fractions: Tuple[float, float] = (0.5, 0.5)) -> Dict[int, float]:
    """% reduction in prefill duration (paper Table 1 cell format)."""
    out = {}
    for s in prompt_lengths:
        base = prefill_time(cfg, s, hw_name, tp, iso=False, int8_comm=int8_comm)
        lengths = [int(s * f) for f in fractions[:-1]]
        lengths.append(s - sum(lengths))
        t_iso = prefill_time(cfg, s, hw_name, tp, lengths=lengths,
                             int8_comm=int8_comm)
        out[s] = 100.0 * (1.0 - t_iso / base)
    return out
