"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks, 3 mLSTM : 1 sLSTM per period.  [arXiv:2405.04517]

Under TP the 4 heads do not shard; the mLSTM value/output feature dim
(256 a head) shards instead, so mLSTM blocks still end in the TP all-reduce
ISO overlaps.  sLSTM blocks are replicated and sequential: the case where
ISO does not apply (their stage does not reduce)."""
from repro_torch.config import ModelConfig, register


@register("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        pos_type="none",
        source="arXiv:2405.04517",
    )
