"""Whisper-base — encoder-decoder ASR backbone; conv frontend stubbed.

[arXiv:2212.04356; unverified]  6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865. ``input_specs()`` provides precomputed frame embeddings
(B, 1500, d_model) — the mel+conv frontend is a stub per the assignment.
Full attention enc-dec => long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    enc_layers=6,
    num_frames=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    tied_embeddings=True,
)
