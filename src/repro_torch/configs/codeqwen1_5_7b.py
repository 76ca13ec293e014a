"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416; qwen1.5 architecture (no qk_norm).  [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.config import ModelConfig, register


@register("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qk_norm=False,
        rope_theta=1e6,
        source="hf:Qwen/CodeQwen1.5-7B",
    )
