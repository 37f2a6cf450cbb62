"""Mistral-Large-Instruct-2407 123B  [dense]  [hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=32768,
    mlp_type="swiglu", rope_theta=1e6,
    # 123B dense: fp32 moments do not fit 256 chips; bf16 moments do.
    optimizer="adamw_bf16", grad_accum=4,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
