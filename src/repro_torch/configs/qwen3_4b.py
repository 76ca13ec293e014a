"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm + GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.config import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,                     # qwen3 decouples head_dim from d_model/H
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B",
    )
