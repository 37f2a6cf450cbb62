"""Jamba-v0.1 52B  [hybrid]  Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_d_ff=14336,
    moe_layer_period=2, moe_offset=1,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, conv_kernel=4,
    attn_layer_period=8, attn_layer_offset=4,
    mlp_type="swiglu", rope_theta=1e6,
    optimizer="adamw_bf16",
    source="arXiv:2403.19887; hf",
)
