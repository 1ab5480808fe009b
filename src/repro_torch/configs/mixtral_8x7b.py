"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
SWA window 4096 => sub-quadratic; runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attn_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336, capacity_factor=1.25),
    tied_embeddings=False,
    rope_theta=1e6,
)
