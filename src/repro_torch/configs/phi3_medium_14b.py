"""Phi-3-medium 14B  [dense]  [arXiv:2404.14219; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    head_dim=128, d_ff=17920, vocab_size=100352,
    mlp_type="swiglu", rope_theta=1e6,
    source="arXiv:2404.14219; unverified",
)
