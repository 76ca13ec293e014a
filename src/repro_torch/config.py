"""Configuration for the PyTorch port (a copy of ``repro/config.py``).

Frozen dataclasses, so configs are hashable, and a string registry so the
launcher can select ``--arch <id>``.  The fields and defaults are the
reference's; only the parts the port's slice reaches are kept (no input-shape
table, no ladder twins).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# Block kinds understood by models/decoder.py.
BLOCK_ATTN_MLP = "attn_mlp"          # classic transformer block
BLOCK_ATTN_MOE = "attn_moe"          # attention + MoE FFN
BLOCK_HYBRID = "hybrid"              # parallel attention + mamba heads (hymba)
BLOCK_MLSTM = "mlstm"                # xLSTM matrix-memory block
BLOCK_SLSTM = "slstm"                # xLSTM scalar-memory block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert_d_ff: int = 0

    def padded_experts(self, shards: int) -> int:
        return int(math.ceil(self.num_experts / shards) * shards)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = (BLOCK_ATTN_MLP,)  # tiled over layers
    qk_norm: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    norm_type: str = "rms"           # rms | ln
    mlp_type: str = "swiglu"         # swiglu | gelu
    pos_type: str = "rope"           # rope | sinusoidal | none
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention; >0 window variant
    attn_impl: str = "dense"         # dense | blockwise
    attn_block_k: int = 1024
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0
    encoder_frames: int = 1500
    num_patches: int = 0
    residual_wiring: str = "standard"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def param_count(self) -> int:
        """Parameters of a dense (``attn_mlp``) stack, norms included."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        attn = 2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        total += self.num_layers * (attn + mlp_mats * d * self.d_ff + 2 * d)
        return int(total)


@dataclass(frozen=True)
class ParallelConfig:
    data: int = 16
    model: int = 16
    pods: int = 1
    seq_parallel: bool = False


@dataclass(frozen=True)
class ISOConfig:
    """The paper's technique, as a first-class runtime feature."""
    enabled: bool = True
    num_chunks: int = 2              # paper: 2; >2 is the beyond-paper extension
    split_fractions: Tuple[float, ...] = ()   # empty -> policy decides
    split_policy: str = "even"       # even | asymmetric | adaptive | auto
    quantized_comm: bool = False     # int8 collectives
    min_chunk_tokens: int = 256      # below this, ISO is skipped
    chunk_align: int = 128           # chunk-length multiple


@dataclass(frozen=True)
class ServingConfig:
    """Paged-KV continuous-batching engine (serving/paged_engine.py).

    Every field and default of the reference's ``ServingConfig``; the port's
    engine raises ``NotImplementedError`` for the settings its slice does not
    run (see ``PagedEngine.__init__``)."""
    page_size: int = 16              # tokens per KV page
    num_pages: int = 0               # 0 -> max_batch * ceil(max_len/page_size)
    prefill_token_budget: int = 512  # max prefill tokens per engine step
    scheduler_policy: str = "fcfs"   # fcfs | priority
    max_batch: int = 8               # decode batch width (slot count)
    max_len: int = 512               # per-request token capacity
    decode_overlap: bool = True
    prefix_sharing: bool = True
    grant_bucketing: bool = True
    grant_buckets: Tuple[int, ...] = ()   # empty -> power-of-two ladder
    min_grant_bucket: int = 16
    prefill_batching: bool = True
    spec_k: int = 0
    # split-KV flash-decode: 0 = auto (split by decode_split_factor once the
    # deepest resident request spans >= decode_split_min_pages pages),
    # 1 = sequential walk, >1 forces that split count
    decode_kv_splits: int = 0
    decode_split_factor: int = 4
    decode_split_min_pages: int = 16
    decode_schedule: str = "auto"
    latency_hiding: bool = False
    observability: bool = True
    trace_events: int = 65536
    cost_table: str = ""
    cost_model: Optional[object] = field(default=None, compare=False,
                                         repr=False, hash=False)
    disagg: bool = False
    decode_pool_pages: int = 0
    migrate_batch: int = 0


@dataclass(frozen=True)
class RuntimeConfig:
    mode: str = "serve"              # serve | train
    dtype: str = "bfloat16"
    seq_len: int = 4096
    global_batch: int = 256
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    max_steps: int = 1000
    grad_clip: float = 1.0
    remat: bool = True
    grad_comm_int8: bool = False
    zero1: bool = False
    unroll_layers: bool = False
    max_decode_steps: int = 64
    page_size: int = 256


@dataclass(frozen=True)
class Config:
    model: ModelConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    iso: ISOConfig = field(default_factory=ISOConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Padding helpers (TP divisibility)
# ---------------------------------------------------------------------------

def pad_to_multiple(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m) if m > 1 else x


def padded_vocab(cfg: ModelConfig, shards: int) -> int:
    return pad_to_multiple(cfg.vocab_size, max(shards * 128, 2048))


def padded_heads(n_heads: int, shards: int) -> int:
    return pad_to_multiple(n_heads, shards)


def effective_kv_heads(n_kv: int, shards: int) -> int:
    """vLLM GQA rule: replicate KV heads up to the TP degree when tp > kv."""
    if n_kv >= shards:
        return pad_to_multiple(n_kv, shards)
    return shards


def padded_ff(d_ff: int, shards: int) -> int:
    return pad_to_multiple(d_ff, shards * 128) if d_ff else 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
