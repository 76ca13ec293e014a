"""Model API used by launch/ and serving/ (port of the dense subset of
``repro/models/api.py``).

  init_params(seed, cfg, tp, dtype, device, rank) -> params
  prefill(params, cfg, ctx, iso, batch, ...)  -> dict (logits_local, ...)
  decode_step(params, cfg, ctx, tokens, caches, lengths, ...)
                                              -> (logits_local, caches)

``batch`` is ``{"tokens": (B, S) integer}`` for the dense family.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ISOConfig, ModelConfig
from repro_torch.core.overlap import AxisCtx
from repro_torch.device import resolve_device
from repro_torch.models import decoder as dec_lib


def init_params(seed: int, cfg: ModelConfig, tp: int = 1,
                dtype=torch.bfloat16, device=None, rank: int = None):
    """Random weights made on ``device`` (default ``cuda``; raises when CUDA
    is absent unless ``device="cpu"``).  ``rank`` given: only that rank's
    shard of the tp=``tp`` model (see decoder.init_decoder_params)."""
    return dec_lib.init_decoder_params(seed, cfg, tp, dtype,
                                       device=resolve_device(device),
                                       rank=rank)


def prefill(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig,
            batch: Dict[str, Any], **kw):
    return dec_lib.prefill(params, cfg, ctx, iso, tokens=batch["tokens"],
                           **kw)


def decode_step(params, cfg: ModelConfig, ctx: AxisCtx, tokens, caches,
                lengths, block_tables=None, decode_mask=None,
                kv_splits: int = 1, schedule: str = None):
    """See models/decoder.decode_step."""
    return dec_lib.decode_step(params, cfg, ctx, tokens, caches, lengths,
                               block_tables=block_tables,
                               decode_mask=decode_mask, kv_splits=kv_splits,
                               schedule=schedule)
