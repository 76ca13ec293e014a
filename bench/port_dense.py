"""The port's side of a dense decoder's configuration file: the
``ModelConfig`` that ``repro_torch`` builds its engine from, out of the
file's published (Hugging Face) key names.  A configuration names this
module under ``port``."""
from __future__ import annotations

from typing import Dict

import counts


def model_config(cfg: Dict):
    from repro_torch.config import ModelConfig
    if cfg["family"] != "dense":
        raise ValueError(f"{cfg['name']}: family {cfg['family']!r} is not "
                         f"a dense decoder")
    s = counts.Sizes(cfg)
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=s.layers, d_model=s.d,
        num_heads=s.hq, num_kv_heads=s.hkv, head_dim=s.hd, d_ff=s.ff,
        vocab_size=s.vocab, qk_norm=bool(cfg.get("qk_norm")),
        rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg.get("tie_word_embeddings")),
        source=cfg["source"])
