"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(/expert) vocab=163840, MoE 384 experts top-8 + 1 shared expert.
[arXiv:2501.kimi2]

Experts shard over the TP ranks (24 a rank at tp=16); the capacity-based
index dispatch of layers/moe.py keeps its dispatch memory at O(T·D) a
top-k slot, where a one-hot dispatch would be O(T·384·C)."""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("kimi-k2-1t-a32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=163840,
        block_pattern=("attn_moe",),
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                      shared_expert_d_ff=2048),
        rope_theta=5e4,
        source="arXiv:2501.kimi2",
    )
