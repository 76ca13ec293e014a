"""int8-quantized all-reduce on ``torch.distributed`` (port of
``repro/core/quantized_collectives.py``), the paper's mitigation for
communication-dominated TP.

Both wire phases carry int8 payloads; the reduction itself runs in fp32 on
each rank, so int8 summation cannot overflow:

    1. split the partial along its last dim into tp shards; quantize each
       (shard row) with a per-row abs-max fp32 scale, shard first
       (``quantize_int8_shards``);
    2. ``all_to_all_single`` the int8 shards and their scales;
    3. dequantize and sum the tp contributions in fp32, in rank order, ->
       this rank's slice of the reduced tensor, and re-quantize it
       (``dequant_sum_quantize_int8``);
    4. ``all_gather`` int8 + scales;
    5. dequantize and reassemble -> the replicated result
       (``dequantize_int8_gathered``).

Steps 1, 3 and 5 are one kernel each (``kernels/int8_quant.py``): three
launches a reduce on the card.  Wire bytes ~= 2 (n-1)/n * size * 1 B,
against 2 (n-1)/n * size * 2 B for a bf16 ring all-reduce.
``quantized_pmean`` (the data-parallel gradient mean) belongs to training
and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.int8_quant import dequant_sum_quantize_int8, \
    dequantize_int8_gathered, quantize_int8_shards

# all-gather into one tensor: ``all_gather_into_tensor``, which newer torch
# renames ``all_gather_single``
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather_stack(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (tp, *x.shape)."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = torch.empty((tp * x2.shape[0], x2.shape[1]), dtype=x.dtype,
                      device=x.device)
    _all_gather_into(out, x2, group=group)
    return out.reshape(tp, *x.shape)


@dataclass
class QuantizedPending:
    """Phase 1 in flight: the exchanged int8 shards and scales land in
    ``q_recv``/``s_recv`` once ``works`` complete."""
    x_dtype: torch.dtype
    q_recv: torch.Tensor                  # (tp, ..., d/tp) int8
    s_recv: torch.Tensor                  # (tp, ..., 1) fp32
    works: tuple
    group: Optional[dist.ProcessGroup]
    tp: int


def quantized_psum_start(x: torch.Tensor, group, tp: int
                         ) -> QuantizedPending:
    """Quantize the tp shards of ``x`` (..., D) and issue wire phase 1 (the
    all-to-all) without waiting for it."""
    d = x.shape[-1]
    if d % tp:
        raise ValueError(f"quantized_psum: last dim {d} is not divisible by "
                         f"tp={tp}")
    # all_to_all_single exchanges dim-0 blocks: the shard axis comes first
    q, scale = quantize_int8_shards(x, tp)    # (tp, ..., d/tp), (tp, ..., 1)
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(scale)
    works = (dist.all_to_all_single(q_recv, q, group=group, async_op=True),
             dist.all_to_all_single(s_recv, scale, group=group,
                                    async_op=True))
    return QuantizedPending(x.dtype, q_recv, s_recv, works, group, tp)


def quantized_psum_finish(pend: QuantizedPending) -> torch.Tensor:
    """Wait for phase 1, reduce this rank's slice in fp32, then run wire
    phase 2 (the all-gather) and return the reduced tensor."""
    for w in pend.works:
        w.wait()
    tp = pend.tp
    # row j of the exchange is rank j's contribution to my slice
    q2, s2 = dequant_sum_quantize_int8(pend.q_recv, pend.s_recv)
    q2_g = all_gather_stack(q2, pend.group, tp)        # (tp, ..., d/tp)
    s2_g = all_gather_stack(s2, pend.group, tp)        # (tp, ..., 1)
    return dequantize_int8_gathered(q2_g, s2_g, pend.x_dtype)   # (..., d)


def quantized_psum(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    """Drop-in for ``all_reduce(x)`` over ``group`` with int8 wire traffic.
    x: (..., D) with D % tp == 0, the same shape on every rank."""
    if tp == 1:
        return x
    return quantized_psum_finish(quantized_psum_start(x, group, tp))
