"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per block.
[arXiv:2411.13676]

25 Q / 5 KV heads do not divide a TP degree of 2 or more: the head-layout
solver pads Q and KV slots with exact zero-padded projections
(layers/heads.py).  Hymba uses sliding-window attention for most layers ->
window=2048 here (the attention and the mamba state are then both O(1) per
decode step)."""
from repro_torch.config import ModelConfig, SSMConfig, register


@register("hymba-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        block_pattern=("hybrid",),
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
        sliding_window=2048,
        rope_theta=1e4,
        source="arXiv:2411.13676",
    )
