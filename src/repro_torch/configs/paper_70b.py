"""paper-70b — the paper's ~70B dense GQA evaluation model (Table 1)."""
from repro_torch.config import ModelConfig, register


@register("paper-70b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paper-70b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,               # GQA
        d_ff=28672,
        vocab_size=125696,
        rope_theta=1e4,
        source="paper §4.1 (70b GQA)",
    )
