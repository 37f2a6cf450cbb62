"""Model / run configuration schema and the architecture registry.

Every assigned architecture provides a module defining ``CONFIG`` built from
``ModelConfig``; ``get_config(name)`` resolves ids like ``glm4-9b`` and
``reduced(cfg)`` derives the CPU-smoke-test variant (same family, tiny
dims).  Input-shape cells (train_4k / prefill_32k / decode_32k / long_500k)
are defined here as well, including per-family applicability (long_500k is
sub-quadratic-only, per the assignment).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 => attention-free)
    num_kv_heads: int
    d_ff: int                   # dense-FFN hidden (0 => no dense FFN)
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # expert hidden size (defaults to d_ff)
    moe_layer_period: int = 1   # layer i is MoE iff i % period == moe_offset
    moe_offset: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0          # d_state (0 => no SSM layers)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    attn_layer_period: int = 0  # hybrid: layer i is attention iff
    attn_layer_offset: int = 0  #   i % period == offset (0 period => per family)

    # --- misc architecture ---
    mlp_type: str = "swiglu"    # swiglu | gelu
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    frontend: str = "none"      # none | audio_frames | vision_patches
    source: str = ""            # provenance tag from the assignment table

    # --- numerics / fit knobs (per-arch defaults for the production mesh) ---
    dtype: str = "bfloat16"
    remat: bool = True
    optimizer: str = "adamw"    # adamw | adamw_bf16 | adafactor
    grad_accum: int = 1         # microbatches per train step
    attn_chunk: int = 512       # XLA blockwise-attention chunk
    unroll_scans: bool = False  # dry-run flops accounting: unroll inner
                                # scans so cost_analysis counts every trip
    accum_dtype: str = "float32"  # microbatch gradient accumulator dtype

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def mixer_kind(self, layer: int) -> str:
        """'attn' or 'ssm' for layer i."""
        if self.ssm_state == 0:
            return "attn"
        if self.num_heads == 0:
            return "ssm"
        # hybrid: attention every attn_layer_period layers
        if self.attn_layer_period and layer % self.attn_layer_period == self.attn_layer_offset:
            return "attn"
        return "ssm"

    def ffn_kind(self, layer: int) -> str:
        """'moe', 'mlp' or 'none' for layer i."""
        if self.num_experts and layer % self.moe_layer_period == self.moe_offset:
            return "moe"
        return "mlp" if self.d_ff > 0 else "none"

    @property
    def block_period(self) -> int:
        """Smallest p such that layer kinds repeat with period p (for scan)."""
        import math
        p = 1
        if self.num_experts:
            p = math.lcm(p, self.moe_layer_period)
        if self.ssm_state and self.num_heads and self.attn_layer_period:
            p = math.lcm(p, self.attn_layer_period)
        return p

    def param_count(self) -> int:
        """Total parameters N (embedding included once unless tied)."""
        d, V = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d * (1 if self.tie_embeddings else 2)
        moe_ff = self.moe_d_ff or self.d_ff
        for i in range(self.num_layers):
            n += d  # pre-mixer norm
            if self.mixer_kind(i) == "attn":
                n += d * self.num_heads * hd            # q
                n += 2 * d * self.num_kv_heads * hd     # k, v
                n += self.num_heads * hd * d            # o
            else:
                din, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                conv_dim = din + 2 * ds
                n += d * (2 * din + 2 * ds + nh)        # in_proj (z,x,B,C,dt)
                n += self.conv_kernel * conv_dim        # conv
                n += 3 * nh                              # A_log, D, dt_bias
                n += din * d                             # out_proj
            kind = self.ffn_kind(i)
            if kind != "none":
                n += d  # pre-ffn norm
            if kind == "mlp":
                mult = 3 if self.mlp_type == "swiglu" else 2
                n += mult * d * self.d_ff
            elif kind == "moe":
                n += d * self.num_experts               # router
                n += self.num_experts * 3 * d * moe_ff
                n += self.num_shared_experts * 3 * d * moe_ff
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        moe_ff = self.moe_d_ff or self.d_ff
        dense_equiv = dataclasses.replace(self, num_experts=0, d_ff=self.d_ff)
        n = dense_equiv.param_count()
        # subtract the dense FFNs that MoE layers replaced, add active experts
        for i in range(self.num_layers):
            if self.num_experts and i % self.moe_layer_period == self.moe_offset:
                if self.d_ff > 0:
                    mult = 3 if self.mlp_type == "swiglu" else 2
                    n -= mult * self.d_model * self.d_ff
                n += self.d_model * self.num_experts
                n += (self.experts_per_token + self.num_shared_experts) * 3 * self.d_model * moe_ff
        return n


# ---------------------------------------------------------------------------
# Input-shape cells (the assignment's 4 shapes).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k requires sub-quadratic sequence mixing: SSM/hybrid only.
    (All assigned archs are decoder-only, so decode shapes always apply.)"""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "glm4-9b",
    "phi4-mini-3.8b",
    "mistral-large-123b",
    "phi3-medium-14b",
    "jamba-v0.1-52b",
    "musicgen-medium",
    "pixtral-12b",
    "kimi-k2-1t-a32b",
    "llama4-maverick-400b-a17b",
    "mamba2-370m",
]

_MODULES = {
    "glm4-9b": "glm4_9b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "mistral-large-123b": "mistral_large_123b",
    "phi3-medium-14b": "phi3_medium_14b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "musicgen-medium": "musicgen_medium",
    "pixtral-12b": "pixtral_12b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mamba2-370m": "mamba2_370m",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: small layers/width, few
    experts, tiny vocab — exercises every structural feature of the arch."""
    period = cfg.block_period
    layers = max(2 * period, 2)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = 0
    if heads:
        kv = min(cfg.num_kv_heads, heads)
        if cfg.num_kv_heads == cfg.num_heads:
            kv = heads                       # preserve MHA structure
        elif heads % kv != 0:
            kv = 1
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=96 if cfg.num_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        dtype="float32",
        grad_accum=1,
        attn_chunk=32,
    )
