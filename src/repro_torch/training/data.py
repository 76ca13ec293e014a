"""Synthetic LM data pipeline (a copy of ``repro/training/data.py``, numpy
only: the port draws the reference's batches bit for bit).

Deterministic, seekable token streams so multi-host data parallelism can shard by
``(host_index, step)`` without coordination, plus a document-packing simulation
(random-length docs separated by EOS, packed to fixed windows — what a real prefill
workload looks like).  For the audio/vlm families the stub frontends are random
embeddings with matching token targets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.config import ModelConfig


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 512


class SyntheticLM:
    """Markov-ish synthetic token stream: next token depends on the previous one
    through a fixed random permutation + noise, so models can actually reduce loss
    (pure-uniform data gives nothing to learn)."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.default_rng(dc.seed)
        self.perm = rng.permutation(dc.vocab_size)

    def batch(self, step: int, host: int = 0, num_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        dc = self.dc
        b_loc = dc.global_batch // num_hosts
        rng = np.random.default_rng(
            (dc.seed * 1_000_003 + step) * 65_537 + host)
        toks = np.empty((b_loc, dc.seq_len + 1), np.int32)
        for i in range(b_loc):
            toks[i] = self._pack_docs(rng, dc.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _pack_docs(self, rng, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        filled = 0
        while filled < n:
            dlen = max(2, int(rng.exponential(self.dc.mean_doc_len)))
            dlen = min(dlen, n - filled)
            doc = np.empty(dlen, np.int32)
            doc[0] = rng.integers(2, self.dc.vocab_size)
            noise = rng.random(dlen) < 0.15
            rand = rng.integers(2, self.dc.vocab_size, dlen)
            for t in range(1, dlen):
                doc[t] = rand[t] if noise[t] else self.perm[doc[t - 1]]
            if dlen >= 2:
                doc[-1] = self.dc.eos_id
            out[filled:filled + dlen] = doc
            filled += dlen
        return out

    def iterator(self, start_step: int = 0, host: int = 0, num_hosts: int = 1
                 ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host, num_hosts)
            step += 1


def make_training_batch(cfg: ModelConfig, seq_len: int, global_batch: int,
                        step: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Family-aware batch: adds stub frontend embeddings where needed."""
    dc = DataConfig(seq_len=seq_len, global_batch=global_batch,
                    vocab_size=cfg.vocab_size, seed=seed)
    base = SyntheticLM(dc).batch(step)
    rng = np.random.default_rng(seed * 7919 + step)
    if cfg.family == "audio":
        base["frames"] = (rng.standard_normal(
            (global_batch, cfg.encoder_frames, cfg.d_model)) * 0.1
        ).astype(np.float32)
    if cfg.family == "vlm":
        n_p = min(cfg.num_patches, max(1, seq_len // 2))
        base["patches"] = (rng.standard_normal(
            (global_batch, n_p, cfg.d_model)) * 0.1).astype(np.float32)
        base["tokens"] = base["tokens"][:, :seq_len - n_p]
        base["labels"] = base["labels"][:, :seq_len - n_p]
    return base
