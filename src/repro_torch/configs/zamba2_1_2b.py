"""Zamba2-1.2B — Mamba2 backbone + one shared (weight-tied) attention block.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32, MHA) d_ff=8192
ssm_state=64 vocab=32000. The shared transformer block is applied every 6
mamba layers (weight-tied across call sites). Hybrid => runs long_500k; the
shared-attention KV cache is windowed at 4096 for that cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,             # mamba2 layers
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=64),
    hybrid_attn_every=6,
    tied_embeddings=True,
)
