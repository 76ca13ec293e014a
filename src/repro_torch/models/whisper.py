"""Whisper-style encoder-decoder backbone (port of ``repro/models/whisper.py``).

The mel-spectrogram and conv frontend is a stub, as in the reference: frames
of shape (B, encoder_frames, D) come in.  The encoder runs bidirectional
attention with the ISO schedule (every chunk attends the whole sequence);
the decoder is a (self-attention, cross-attention, MLP) stack, every stage
ending in a TP all-reduce.  The encoder's output reaches the decoder as
per-layer cross K/V: layer statics of the decoder's prefill, then the
``cross_k``/``cross_v`` leaves of its decode caches.

Parameters: ``{"encoder": {"final_norm", "periods"}, "decoder": {"embed",
"final_norm", "periods"}}`` (the encoder has no embedding).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import BLOCK_ATTN_MLP, BLOCK_DEC, ISOConfig, \
    ModelConfig
from repro_torch.core.overlap import AxisCtx
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.heads import head_layout
from repro_torch.layers.rope import sinusoidal_embedding
from repro_torch.models import decoder as dec_lib


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers, block_pattern=(BLOCK_ATTN_MLP,),
        pos_type="sinusoidal")


def decoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, block_pattern=(BLOCK_DEC,),
                               pos_type="sinusoidal")


def init_whisper_params(seed: int, cfg: ModelConfig, tp: int = 1,
                        dtype=torch.bfloat16, device=None,
                        rank: Optional[int] = None) -> Dict:
    """Random weights: the encoder from ``seed`` (its embedding dropped:
    the stub frontend provides the embeddings), the decoder from
    ``seed + 1``, both laid out for ``tp`` (the reference builds them per
    tp too).  ``rank`` given: that rank's shard of the encoder, the decoder
    and its cross-attention, equal to ``shard_params`` of the whole (see
    decoder.init_decoder_params)."""
    enc = dec_lib.init_decoder_params(seed, encoder_cfg(cfg), tp, dtype,
                                      device=device, rank=rank)
    enc.pop("embed")
    dec = dec_lib.init_decoder_params(seed + 1, decoder_cfg(cfg), tp, dtype,
                                      device=device, rank=rank)
    return {"encoder": enc, "decoder": dec}


def encode(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig,
           frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """frames: (B, F, D), the stub frontend's output -> the encoder's hidden
    states (B, F, D) in the frames' dtype (float32 frames against bfloat16
    weights compute in float32, as in the reference).  ``remat``: as
    decoder.prefill's."""
    embeds = frames + sinusoidal_embedding(
        frames.shape[1], cfg.d_model, device=frames.device).to(
            frames.dtype)[None]
    out = dec_lib.prefill(params["encoder"], encoder_cfg(cfg), ctx, iso,
                          embeds=embeds, logits_mode="none", mode="encode",
                          remat=remat)
    return out["hidden"]


def _cross_statics(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """Every decoder layer's cross K/V of ``enc_out``, stacked over
    periods: ``({"cross_k", "cross_v"},)``, each (P, B, F, Hkv, hd)."""
    dcfg = decoder_cfg(cfg)
    kvs = [attn_lib.cross_kv(layer["cross"], enc_out, dcfg)
           for layer in params["decoder"]["periods"][0]]
    return ({"cross_k": torch.stack([k for k, _ in kvs]),
             "cross_v": torch.stack([v for _, v in kvs])},)


def whisper_prefill(params, cfg: ModelConfig, ctx: AxisCtx, iso: ISOConfig,
                    *, frames, tokens, logits_mode: str = "all",
                    return_cache: bool = False, cache_len: int = 0,
                    remat: bool = False) -> Dict[str, Any]:
    """Encode ``frames``, then prefill the decoder on ``tokens`` with the
    cross K/V as layer statics.  With ``return_cache`` the decoder's caches
    also carry the cross K/V (in the encoder's dtype; the engine casts them
    into its own caches).  ``enc_out`` is the encoder's output."""
    enc_out = encode(params, cfg, ctx, iso, frames, remat=remat)
    statics = _cross_statics(params, cfg, enc_out)
    out = dec_lib.prefill(params["decoder"], decoder_cfg(cfg), ctx, iso,
                          tokens=tokens, logits_mode=logits_mode,
                          return_cache=return_cache, cache_len=cache_len,
                          layer_statics=statics, remat=remat)
    if return_cache:
        out["caches"] = (dict(out["caches"][0], **statics[0]),)
    out["enc_out"] = enc_out
    return out


def whisper_decode_step(params, cfg: ModelConfig, ctx: AxisCtx, tokens,
                        caches, lengths):
    return dec_lib.decode_step(params["decoder"], decoder_cfg(cfg), ctx,
                               tokens, caches, lengths)


def init_whisper_caches(cfg: ModelConfig, batch: int, cache_len: int,
                        tp: int = 1, dtype=torch.bfloat16, device=None,
                        local: bool = False):
    """Decode caches with zero cross K/V placeholders (filled by a real
    prefill): ``({k, v, pos, cross_k, cross_v},)``; ``local``: one tp
    rank's kv heads (decoder.init_caches)."""
    caches = dec_lib.init_caches(decoder_cfg(cfg), batch, cache_len, tp,
                                 dtype, device, local=local)
    hkv = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), tp).hkv_eff
    hkv //= tp if local else 1
    shape = (cfg.num_layers, batch, cfg.encoder_frames, hkv,
             cfg.resolved_head_dim)
    return (dict(caches[0],
                 cross_k=torch.zeros(shape, dtype=dtype, device=device),
                 cross_v=torch.zeros(shape, dtype=dtype, device=device)),)
