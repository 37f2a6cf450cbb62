"""MusicGen-medium  [audio]  decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB — input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    mlp_type="gelu", rope_theta=1e4,
    frontend="audio_frames",
    source="arXiv:2306.05284; hf",
)
