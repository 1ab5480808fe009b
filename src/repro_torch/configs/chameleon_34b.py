"""Chameleon-34B — early-fusion VLM over VQ image tokens.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (text + VQ-VAE image codes in one vocabulary). qk-norm per paper.
The modality frontend (VQ tokenizer) is a STUB: ``input_specs()`` provides the
precomputed token ids — for early fusion the VQ codes *are* vocabulary entries,
so the backbone input is an ordinary token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,              # chameleon stabilizes early fusion with qk-norm
    tied_embeddings=False,
)
