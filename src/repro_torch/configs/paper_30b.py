"""paper-30b — the paper's ~30B dense MHA evaluation model (Table 1).

The paper (Baichuan) does not publish exact dims; this uses standard 30B-class
MHA sizing consistent with the stated "30b (MHA)".
"""
from repro_torch.config import ModelConfig, register


@register("paper-30b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paper-30b",
        family="dense",
        num_layers=48,
        d_model=6656,
        num_heads=52,
        num_kv_heads=52,              # MHA
        d_ff=17920,
        vocab_size=125696,
        rope_theta=1e4,
        source="paper §4.1 (30b MHA)",
    )
