"""Mamba2-370m  [ssm]  SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, conv_kernel=4,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
