"""Model API used by launch/, serving/ and training/ (port of
``repro/models/api.py``; every family of the reference).

  init_params(seed, cfg, tp, dtype, device, rank) -> params
  prefill(params, cfg, ctx, iso, batch, ...)  -> dict (logits_local, ...)
  decode_step(params, cfg, ctx, tokens, caches, lengths, ...)
                                              -> (logits_local, caches)
  init_caches(cfg, batch, cache_len, tp, dtype, device, local)
                                              -> dense caches
  init_state_caches(cfg, batch, tp, dtype, device, local)
                                              -> per-slot recurrent states
  make_inputs(cfg, seq_len, batch, seed, dtype, device) -> batch

``prefill``'s dict carries ``moe_aux``, the MoE load-balance aux (0.0
without MoE).  ``batch`` is ``{"tokens": (B, S) integer}`` for the dense,
MoE, hybrid and ssm families, ``{"frames": (B, F, D), "tokens": (B,
S)}`` for audio (whisper; the frames are the stub frontend's output) and
``{"tokens": (B, S_text), "patches": (B, P, D)}`` for vlm (the stub vision
encoder's output, prepended to the text).  A vlm batch without
``patches`` is text alone: a text-only request, or a resumed grant whose
patches are already in the KV pages.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ISOConfig, ModelConfig
from repro_torch.core.overlap import AxisCtx
from repro_torch.device import generator, resolve_device
from repro_torch.models import decoder as dec_lib
from repro_torch.models import whisper as whisper_lib


def init_params(seed: int, cfg: ModelConfig, tp: int = 1,
                dtype=torch.bfloat16, device=None, rank: int = None):
    """Random weights made on ``device`` (default ``cuda``; raises when CUDA
    is absent unless ``device="cpu"``).  ``rank`` given: only that rank's
    shard of the tp=``tp`` model (see decoder.init_decoder_params and
    whisper.init_whisper_params)."""
    device = resolve_device(device)
    if cfg.family == "audio":
        return whisper_lib.init_whisper_params(seed, cfg, tp, dtype, device,
                                               rank=rank)
    return dec_lib.init_decoder_params(seed, cfg, tp, dtype, device=device,
                                       rank=rank)


def prefill(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig,
            batch: Dict[str, Any], **kw):
    if cfg.family == "audio":
        return whisper_lib.whisper_prefill(
            params, cfg, ctx, iso, frames=batch["frames"],
            tokens=batch["tokens"], **kw)
    if cfg.family == "vlm":
        # the reference reads batch["patches"] unconditionally and so
        # raises KeyError on a batch of text alone (ROADMAP queue C)
        return dec_lib.prefill(params, cfg, ctx, iso, tokens=batch["tokens"],
                               extra_embeds=batch.get("patches"), **kw)
    return dec_lib.prefill(params, cfg, ctx, iso, tokens=batch["tokens"],
                           **kw)


def decode_step(params, cfg: ModelConfig, ctx: AxisCtx, tokens, caches,
                lengths, block_tables=None, decode_mask=None,
                kv_splits: int = 1, schedule: str = None, moe_hits=None):
    """See models/decoder.decode_step; audio decodes its dense caches."""
    if cfg.family == "audio":
        if block_tables is not None:
            raise NotImplementedError("paged decode of an encoder-decoder: "
                                      "the dense Engine serves audio")
        return whisper_lib.whisper_decode_step(params, cfg, ctx, tokens,
                                               caches, lengths)
    return dec_lib.decode_step(params, cfg, ctx, tokens, caches, lengths,
                               block_tables=block_tables,
                               decode_mask=decode_mask, kv_splits=kv_splits,
                               schedule=schedule, moe_hits=moe_hits)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, tp: int = 1,
                dtype=torch.bfloat16, device=None, local: bool = False):
    """Empty dense decode caches (the dense ``Engine``'s), made on
    ``device`` (default ``cuda``, as ``init_params``); ``local``: one tp
    rank's shard (decoder.init_caches)."""
    device = resolve_device(device)
    if cfg.family == "audio":
        return whisper_lib.init_whisper_caches(cfg, batch, cache_len, tp,
                                               dtype=dtype, device=device,
                                               local=local)
    return dec_lib.init_caches(cfg, batch, cache_len, tp, dtype, device,
                               local=local)


def init_state_caches(cfg: ModelConfig, batch: int, tp: int = 1,
                      dtype=torch.bfloat16, device=None, local: bool = False):
    """Per-slot recurrent-state caches for the paged engine: the dense
    caches minus ``k``/``v``/``pos`` (KV lives in the page pool,
    serving/kvcache.py); ``local``: one tp rank's shard (see
    decoder.init_state_caches)."""
    if cfg.family == "audio":
        raise NotImplementedError("the paged engine does not serve "
                                  "encoder-decoder models")
    return dec_lib.init_state_caches(cfg, batch, tp, dtype,
                                     resolve_device(device), local=local)


def make_inputs(cfg: ModelConfig, seq_len: int, global_batch: int,
                seed: int = 0, dtype=torch.bfloat16, device=None
                ) -> Dict[str, torch.Tensor]:
    """Random model inputs from ``seed``: tokens in [0, vocab), and for
    audio frames ~ N(0, 1) x 0.1 of (B, encoder_frames, D); for vlm the
    first ``n_p = min(num_patches, max(1, S // 2))`` of the S positions are
    patches ~ N(0, 1) x 0.1 of (B, n_p, D), the rest text."""
    device = resolve_device(device)
    gen = generator(device, seed)
    B, S = global_batch, seq_len
    n_p = min(cfg.num_patches, max(1, S // 2)) if cfg.family == "vlm" else 0
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - n_p),
                                   generator=gen, dtype=torch.int32,
                                   device=device)}

    def emb(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * 0.1).to(dtype)

    if cfg.family == "audio":
        out["frames"] = emb((B, cfg.encoder_frames, cfg.d_model))
    if n_p:
        out["patches"] = emb((B, n_p, cfg.d_model))
    return out
