"""Qwen3-0.6B — dense, qk_norm, GQA, explicit head_dim=128.

[hf:Qwen/Qwen3-0.6B; hf]  28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,              # Qwen3 decouples head_dim from d_model/num_heads
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tied_embeddings=True,
    rope_theta=1e6,
)
