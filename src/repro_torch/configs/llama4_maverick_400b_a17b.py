"""Llama-4 Maverick 400B-A17B  [moe]  128 experts top-1 + shared expert,
MoE every other layer, early fusion.  [hf:meta-llama; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_d_ff=8192,
    moe_layer_period=2, moe_offset=1, num_shared_experts=1,
    mlp_type="swiglu", rope_theta=5e5,
    optimizer="adamw_bf16", grad_accum=2,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
