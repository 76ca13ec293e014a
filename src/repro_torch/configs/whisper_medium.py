"""whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H d_ff=4096
vocab=51865; conv/mel frontend stubbed, as in the reference: (B, 1500, 1024)
frame embeddings come in.  [arXiv:2212.04356]"""
from repro_torch.config import BLOCK_DEC, ModelConfig, register

# the decoder's own context, ``n_text_ctx`` in the published model
# dimensions: the dense Engine's max_len for this model
N_TEXT_CTX = 448


@register("whisper-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        block_pattern=(BLOCK_DEC,),
        norm_type="ln",
        mlp_type="gelu",
        pos_type="sinusoidal",
        encoder_layers=24,
        encoder_frames=1500,
        source="arXiv:2212.04356",
    )
