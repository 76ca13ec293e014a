"""The port's side of an afmoe configuration file (Arcee Trinity): the
``AfmoeModelConfig`` that ``repro_torch`` builds its engine from, out of
the file's published (Hugging Face) key names.  A configuration names this
module under ``port``.

On a checkout whose port has no afmoe family this raises ImportError at
once, before any weight is made."""
from __future__ import annotations

from typing import Dict

LAYER_TYPES = ("sliding_attention", "full_attention")


def model_config(cfg: Dict):
    from repro_torch.config import AfmoeModelConfig, SigmoidMoEConfig, \
        afmoe_pattern
    name = cfg["name"]
    if cfg["family"] != "afmoe" or cfg.get("score_func") != "sigmoid":
        raise ValueError(f"{name}: not an afmoe configuration with a "
                         f"sigmoid router")
    for key, want in (("n_group", 1), ("num_expert_groups", 1),
                      ("topk_group", 1), ("num_limited_groups", 1),
                      ("rope_scaling", None), ("hidden_act", "silu")):
        if cfg.get(key, want) != want:
            raise ValueError(f"{name}: {key}={cfg[key]!r}; the port takes "
                             f"{want!r}")
    types = list(cfg["layer_types"])
    layers = int(cfg["num_hidden_layers"])
    if len(types) != layers or set(types) - set(LAYER_TYPES):
        raise ValueError(f"{name}: layer_types must name {layers} layers "
                         f"of {LAYER_TYPES}")
    d = int(cfg["hidden_size"])
    f_e = int(cfg["moe_intermediate_size"])
    return AfmoeModelConfig(
        name=name, family="afmoe", num_layers=layers, d_model=d,
        num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg["head_dim"]), d_ff=int(cfg["intermediate_size"]),
        vocab_size=int(cfg["vocab_size"]),
        block_pattern=afmoe_pattern(
            tuple(t == "full_attention" for t in types),
            int(cfg["num_dense_layers"])),
        qk_norm=bool(cfg.get("qk_norm", True)),
        rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        sliding_window=int(cfg["sliding_window"]),
        moe=SigmoidMoEConfig(
            num_experts=int(cfg["num_experts"]),
            top_k=int(cfg["num_experts_per_tok"]), d_ff_expert=f_e,
            shared_expert_d_ff=f_e * int(cfg["num_shared_experts"]),
            route_scale=float(cfg["route_scale"]),
            route_norm=bool(cfg["route_norm"])),
        embed_scale=d ** 0.5 if cfg.get("mup_enabled") else 1.0,
        source=cfg["source"])
