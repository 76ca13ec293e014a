"""Training (port of ``repro/training``): the synthetic data, the
vocab-sharded loss, AdamW, ZeRO-1, checkpoints and the train step."""
