"""Pixtral-12B  [vlm]  pixtral-ViT frontend (STUB: input_specs() provides
precomputed patch embeddings) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    mlp_type="swiglu", rope_theta=1e6,
    frontend="vision_patches",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
