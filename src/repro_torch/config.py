"""Configuration for the PyTorch port (a copy of ``repro/config.py``).

Frozen dataclasses, so configs are hashable, and a string registry so the
launcher can select ``--arch <id>``.  The fields and defaults are the
reference's, and so is the input-shape table of the dry run
(``INPUT_SHAPES``).  ``ladder_variant`` builds the ladder-residual twin of a
config.
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
BLOCK_DEC = "dec_block"              # whisper decoder: self-, cross-attn, MLP
# afmoe (Arcee Trinity): gated attention with q/k norm, norms before and
# after each sublayer; a sliding-window layer with RoPE or a full one with
# no position embedding (NoPE); a dense SwiGLU or a dropless MoE FFN
BLOCK_AF_SWA_MLP = "afmoe_swa_mlp"
BLOCK_AF_FULL_MLP = "afmoe_full_mlp"
BLOCK_AF_SWA_MOE = "afmoe_swa_moe"
BLOCK_AF_FULL_MOE = "afmoe_full_moe"
AFMOE_KINDS = (BLOCK_AF_SWA_MLP, BLOCK_AF_FULL_MLP, BLOCK_AF_SWA_MOE,
               BLOCK_AF_FULL_MOE)
MOE_KINDS = (BLOCK_ATTN_MOE, BLOCK_AF_SWA_MOE, BLOCK_AF_FULL_MOE)
# stacks of these kinds carry no recurrent state: grants may be padded,
# packed, shared and speculated
ATTN_KINDS = (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE) + AFMOE_KINDS


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
class SigmoidMoEConfig(MoEConfig):
    """afmoe's router (not in the reference; a ``MoEConfig`` routes as the
    reference does: softmax, capacity drops): fp32 sigmoid scores s; the top
    k of s + b, b a per-expert bias (the ``expert_bias`` leaf) that chooses
    experts and weighs nothing; weights s at the chosen experts, divided by
    their sum + 1e-20 where ``route_norm``, times ``route_scale``; every
    assignment computed (dropless: no capacity, so the output does not
    depend on how tokens are batched).  ``capacity_factor`` is unused."""
    route_scale: float = 1.0
    route_norm: bool = True


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

    def param_count(self, active_only: bool = False) -> int:
        """Parameters counted as the reference counts them, norms included:
        its LayerNorm biases and whisper's norm_cross apart, and for a
        ``hybrid`` layer without the SSM's ``w_dt``, ``w_b`` and ``w_c``
        (the tensors hold more than this).  ``active_only``: an MoE layer
        counts the ``top_k`` experts a token runs through, not all of them
        (the router and the shared expert count whole either way)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        attn = 2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            if kind in (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE, BLOCK_HYBRID,
                        BLOCK_DEC) + AFMOE_KINDS:
                total += attn
            if kind in AFMOE_KINDS:
                # the output gate; the norms after each sublayer
                total += d * self.num_heads * hd + 2 * d
            if kind in MOE_KINDS:
                m = self.moe
                n_e = m.top_k if active_only else m.num_experts
                total += 3 * d * m.d_ff_expert * n_e
                total += d * m.num_experts                  # router
                total += 3 * d * m.shared_expert_d_ff
                if isinstance(m, SigmoidMoEConfig):
                    total += m.num_experts                  # expert bias
            elif kind == BLOCK_HYBRID:
                s = self.ssm
                inner = s.expand * d
                total += 3 * d * inner + inner * (2 * s.state_dim + 1)
                total += 3 * d * self.d_ff
            elif kind == BLOCK_MLSTM:
                total += 4 * d * 2 * d + 3 * d * d
            elif kind == BLOCK_SLSTM:
                total += 8 * d * d                # input and recurrent gates
            else:
                total += mlp_mats * d * self.d_ff
            if kind == BLOCK_DEC:                           # cross-attention
                total += attn
            total += 2 * d                                  # norms
        total += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff + 2 * d)
        return int(total)


@dataclass(frozen=True)
class AfmoeModelConfig(ModelConfig):
    """A configuration of the afmoe family (Arcee Trinity; not in the
    reference's registry).  Its ``block_pattern`` names one kind a layer
    (``AFMOE_KINDS``: sliding or full attention, dense or MoE FFN), so it
    is one period long; ``sliding_window`` is the sliding layers' window
    and ``moe`` a ``SigmoidMoEConfig``.  ``embed_scale`` multiplies the
    token embeddings (sqrt(d_model) under muP)."""
    embed_scale: float = 1.0


def afmoe_pattern(full: Tuple[bool, ...], dense_layers: int
                  ) -> Tuple[str, ...]:
    """An afmoe ``block_pattern``: layer i full attention where ``full[i]``
    (else sliding), a dense FFN below ``dense_layers`` (else MoE)."""
    kinds = {(False, True): BLOCK_AF_SWA_MLP, (True, True): BLOCK_AF_FULL_MLP,
             (False, False): BLOCK_AF_SWA_MOE,
             (True, False): BLOCK_AF_FULL_MOE}
    return tuple(kinds[(f, i < dense_layers)] for i, f in enumerate(full))


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
# Input shape assignments (the dry run's cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def ladder_variant(cfg: ModelConfig, name: str = "") -> ModelConfig:
    """Ladder-residual twin of a standard-wired config: the same shapes and
    parameter layout, the residual stream rewired
    (``residual_wiring="ladder"``) so each stage's TP all-reduce completes
    behind the next stage's compute.  Attention stacks only: every stage
    must end in a reduce (models/blocks.pattern_all_reduces)."""
    from repro_torch.models.blocks import pattern_all_reduces
    assert cfg.residual_wiring == "standard", cfg.name
    assert all(k in (BLOCK_ATTN_MLP, BLOCK_ATTN_MOE)
               for k in cfg.block_pattern) and \
        pattern_all_reduces(cfg.block_pattern), \
        f"ladder wiring needs an all-reducing attention stack: {cfg.name}"
    return dataclasses.replace(cfg, name=name or f"ladder-{cfg.name}",
                               residual_wiring="ladder")


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
    from repro_torch.configs import UNPORTED  # populates the registry
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is registered by the reference but not served by "
            f"the port yet: ROADMAP queue A item {UNPORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401  (populates the registry)
    return sorted(_REGISTRY)
