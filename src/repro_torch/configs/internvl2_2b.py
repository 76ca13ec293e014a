"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553; the InternLM2 language backbone in full, the InternViT vision
encoder and its projector stubbed: a request carries 256 pre-projected
patch embeddings, prepended to its text.  [arXiv:2404.16821]"""
from repro_torch.config import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        num_patches=256,
        rope_theta=1e6,
        source="arXiv:2404.16821",
    )
