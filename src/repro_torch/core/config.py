"""Configuration dataclasses — the port's own copy of
``repro/core/config.py`` (the port imports nothing from the JAX package).

The fields and ``ValueError``s match the reference so a preset reads the
same in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

GATE_STRATEGIES = (
    "topk", "switch", "gshard", "ktop1", "sam", "base", "hash",
    "dense_to_sparse",
)

# The auto-tuning sentinel (core/tuning.py resolves it at the choke points).
AUTO = "auto"

A2A_MODES = ("flat", "hierarchical")

PAYLOAD_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")

# sort    = HetuMoE layout transform into the capacity-padded (E·C, d) buffer
# dense   = one-hot einsum baseline (GShard/DeepSpeed)
# grouped = dropless: expert-sorted (S·K, d) buffer + grouped expert matmuls
DISPATCH_MODES = ("sort", "dense", "grouped")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts layer configuration (see the reference for the
    meaning of each knob; the tuned ones accept ``"auto"``)."""
    num_experts: int
    top_k: int = 1
    gate: str = "switch"
    capacity_factor: float = 1.25
    d_ff_expert: Optional[int] = None
    num_shared_experts: int = 0
    num_prototypes: int = 1
    num_groups: int = 1
    dispatch: str = "sort"
    a2a: str = "flat"
    a2a_inner: int = 4
    grouped_ep_bound_factor: Optional[float] = None
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 0.0
    router_dtype: str = "float32"
    gumbel_temperature: float = 1.0
    # The reference's switch between its Pallas kernels and plain XLA.  The
    # port always runs its kernels on a CUDA tensor (their plain versions
    # on a CPU one), so it defaults to True; False raises on the card
    # (core/moe.py), where the port has no kernel-free layer.
    use_pallas_gate: bool = True
    # A TPU tiling knob in the reference; the port resolves it for config
    # parity, but the CUDA grouped-matmul kernel picks its own tile.
    grouped_block_m: Optional[int] = None
    overlap_chunks: int = 1
    payload_dtype: Optional[str] = None

    def __post_init__(self):
        if self.gate not in GATE_STRATEGIES:
            raise ValueError(
                f"MoEConfig.gate={self.gate!r} is not a known gating "
                f"strategy; valid options: {GATE_STRATEGIES}")
        if self.a2a not in A2A_MODES + (AUTO,):
            raise ValueError(
                f"MoEConfig.a2a={self.a2a!r} is not a known AllToAll "
                f"mode; valid options: {A2A_MODES + (AUTO,)}")
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"MoEConfig.dispatch={self.dispatch!r} is not a known "
                f"dispatch mode; valid options: {DISPATCH_MODES}")
        if self.a2a_inner < 1:
            raise ValueError(
                f"MoEConfig.a2a_inner must be >= 1, got {self.a2a_inner}")
        f = self.grouped_ep_bound_factor
        if f is not None and f != AUTO and (
                not isinstance(f, (int, float)) or f <= 0):
            raise ValueError(
                f"MoEConfig.grouped_ep_bound_factor must be positive, "
                f"None, or {AUTO!r}, got {f!r}")
        bm = self.grouped_block_m
        if bm is not None and bm != AUTO and (
                not isinstance(bm, int) or bm < 1):
            raise ValueError(
                f"MoEConfig.grouped_block_m must be an int >= 1, None, or "
                f"{AUTO!r}, got {bm!r}")
        if self.overlap_chunks != AUTO and (
                not isinstance(self.overlap_chunks, int)
                or self.overlap_chunks < 1):
            raise ValueError(
                f"MoEConfig.overlap_chunks must be an int >= 1 (1 disables "
                f"the overlapped pipeline) or {AUTO!r}, got "
                f"{self.overlap_chunks!r}")
        pd = self.payload_dtype
        if pd is not None and pd != AUTO and pd not in PAYLOAD_DTYPES:
            raise ValueError(
                f"MoEConfig.payload_dtype={pd!r} is not a known exchange "
                f"wire dtype; valid options: None (compute dtype), "
                f"{PAYLOAD_DTYPES}, or {AUTO!r}")


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    rope_theta: float = 10_000.0
    use_rope: bool = True
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    causal: bool = True
    qk_norm: bool = False


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 128
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' time-mix configuration."""
    head_dim: int = 64
    chunk_size: int = 128
    decay_lora: int = 64       # low-rank dim for data-dependent decay
    mix_lora: int = 32         # low-rank dim for token-shift interpolation


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder_only: bool = False
    frontend: Optional[str] = None
    act: str = "swiglu"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    final_softcap: Optional[float] = None
    local_window: int = 4096
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    scale_embeddings: bool = False
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible "
                f"by pattern period {len(self.block_pattern)}")
        kinds = set(self.block_pattern)
        if kinds & {"attn", "local", "global", "moe", "dense", "mamba_sa"} \
                and self.attention is None:
            raise ValueError(f"{self.name}: needs AttentionConfig")
        if "moe" in kinds and self.moe is None:
            raise ValueError(f"{self.name}: needs MoEConfig")
        if kinds & {"mamba", "mamba_sa"} and self.ssm is None:
            raise ValueError(f"{self.name}: needs SSMConfig")
        if "rwkv" in kinds and self.rwkv is None:
            raise ValueError(f"{self.name}: needs RWKVConfig")

    @property
    def head_dim(self) -> int:
        a = self.attention
        if a is None:
            return 0
        return a.head_dim if a.head_dim is not None else self.d_model // a.num_heads

    @property
    def num_super_blocks(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if every block is O(seq) at decode with bounded state (the
        reference's rule)."""
        for kind in self.block_pattern:
            if kind in ("mamba", "rwkv", "mamba_sa"):
                continue  # mamba_sa's shared attention decodes windowed
            if kind == "local":
                continue
            if kind == "attn" and self.attention.window is not None:
                continue
            # global layers (gemma2) are capped to a window only in the
            # long-context serving variant
            return False
        return True

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1              # gradient accumulation
    remat: str = "none"                # none | block | full
    optimizer_state_dtype: str = "float32"   # "bfloat16" for the giant configs
    schedule: str = "cosine"
    seed: int = 0
    # -- fault tolerance (training/train_step.py skip-step guard) ----------
    # Loss scaling for bf16 stability: a float is a static scale (1.0 = off);
    # "dynamic" starts at 2^15, halves on every non-finite step, and doubles
    # after loss_scale_growth_interval consecutive finite steps (capped).
    loss_scale: object = 1.0           # float | "dynamic"
    loss_scale_growth_interval: int = 200
    # Non-finite steps are skipped (params/opt state untouched); the training
    # loop fails fast once this many CONSECUTIVE steps have been skipped.
    max_skipped_steps: int = 25

    def __post_init__(self):
        if self.loss_scale != "dynamic":
            try:
                ok = float(self.loss_scale) > 0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"TrainConfig.loss_scale must be a positive float or "
                    f"'dynamic', got {self.loss_scale!r}")
        if self.loss_scale_growth_interval < 1:
            raise ValueError(
                f"TrainConfig.loss_scale_growth_interval must be >= 1, got "
                f"{self.loss_scale_growth_interval}")
        if self.max_skipped_steps < 1:
            raise ValueError(
                f"TrainConfig.max_skipped_steps must be >= 1, got "
                f"{self.max_skipped_steps}")
