"""RWKV6 "Finch" 1.6B — attention-free linear RNN with data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
O(1) per-token state => runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # d_model / rwkv.head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    act="relu2",               # rwkv channel-mix uses squared relu
    tied_embeddings=False,
)
