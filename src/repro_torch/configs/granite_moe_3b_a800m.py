"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
(/expert) vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

40 experts pad to a multiple of the TP degree (48 at tp=16), the padding
experts masked out of the router (layers/moe.py)."""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=49155,
        block_pattern=("attn_moe",),
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
        rope_theta=1e4,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
