"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936,
qk_norm + GQA.  [hf:Qwen/Qwen3-8B family card; 32B sizing]"""
from repro_torch.config import ModelConfig, register


@register("qwen3-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,                     # model-card head_dim (not d_model/H=80)
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B",
    )
