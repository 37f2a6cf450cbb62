"""Kimi K2 1T-A32B  [moe]  trillion-param MoE, 384 experts top-8 + 1 shared.
d_ff=2048 is the per-expert hidden size (the assignment's paper-table row).
[arXiv:2501.kimi2; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=0, vocab_size=163840,
    num_experts=384, experts_per_token=8, moe_d_ff=2048,
    moe_layer_period=1, num_shared_experts=1,
    mlp_type="swiglu", rope_theta=5e7,
    # 1T params: fp32 AdamW moments are 8 TB — use factored second moment +
    # bf16 momentum to fit the pod (see EXPERIMENTS.md memory table).
    optimizer="adafactor", grad_accum=4,
    source="arXiv:2501.kimi2; unverified",
)
