"""GLM-4-9B  [dense]  [hf:THUDM/glm-4-9b; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13696, vocab_size=151552,
    mlp_type="swiglu", rope_theta=1e7,
    source="hf:THUDM/glm-4-9b; hf",
)
