"""Deterministic synthetic data — tokens, frames, images.

Every batch is a pure function of (seed, step), so a restarted job
regenerates exactly the stream it would have seen. The numbers are drawn on
the CPU from seeded ``torch.Generator``s, so one (seed, step) gives one batch
on every device (they are not the JAX package's numbers: ``jax.random``
streams cannot be reproduced in torch).

The LM stream is a mixture of Zipfian unigrams and a first-order Markov chain
(repetition structure) so cross-entropy actually *decreases* under training.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _gen(device, seed: int, *xs: int) -> torch.Generator:
    """A generator seeded by (seed, *xs): distinct streams for distinct
    tuples, the same stream for the same tuple."""
    s = seed & 0xFFFFFFFF
    for x in xs:
        s = (s * 0x9E3779B1 + (x & 0xFFFFFFFF) + 0x7F4A7C15) & 0xFFFFFFFFFFFF
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def lm_batch(cfg: ModelConfig, B: int, S: int, *, seed: int = 0,
             step: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """int64 tokens (B, S) (+ float32 frames (B, F, d) for the enc-dec
    family) on ``device``."""
    g1, g2, g3 = (_gen("cpu", seed, step, i) for i in (1, 2, 3))
    V = cfg.vocab_size
    # zipf-ish marginal via exp-transformed uniforms
    u = torch.rand((B, S), generator=g1) * (1.0 - 1e-6) + 1e-6
    zipf = torch.clamp((u ** (-0.7) - 1.0).to(torch.int64), max=V - 1)
    # markov "copy previous token" structure with p=0.3
    copy = torch.rand((B, S), generator=g2) < 0.3
    tokens = torch.where(copy, torch.roll(zipf, 1, dims=1), zipf)
    batch = {"tokens": tokens.to(device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((B, cfg.num_frames, cfg.d_model),
                                      generator=g3).to(device)
    return batch


def image_batch(cfg: ModelConfig, B: int, *, seed: int = 0, step: int = 0,
                n_classes: Optional[int] = None, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """Gaussian class-cluster images: learnable but synthetic. NHWC float32
    images and int64 labels on ``device``. The numbers are drawn on the CPU so
    that one (seed, step) gives one batch on every device."""
    n_classes = n_classes or cfg.num_classes
    g1, g2 = _gen("cpu", seed, step, 1), _gen("cpu", seed, step, 2)
    labels = torch.randint(0, n_classes, (B,), generator=g1)
    protos = torch.randn((n_classes, 8, 8, 3),
                         generator=_gen("cpu", seed ^ 0x5eed)) * 2.0
    base = protos[labels]                                  # (B, 8, 8, 3)
    # nearest-neighbour resize to (img_res, img_res): output pixel i reads
    # source pixel floor((i + 0.5) * 8 / img_res)
    idx = ((torch.arange(cfg.img_res, dtype=torch.float32) + 0.5)
           * (8.0 / cfg.img_res)).floor().to(torch.int64).clamp_(0, 7)
    base = base[:, idx][:, :, idx]
    noise = torch.randn((B, cfg.img_res, cfg.img_res, 3), generator=g2)
    return {"images": (base + 0.5 * noise).to(device),
            "labels": labels.to(device)}


def batch_for(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
              step: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    if cfg.family == "cnn":
        return image_batch(cfg, shape.global_batch, seed=seed, step=step,
                           device=device)
    return lm_batch(cfg, shape.global_batch, shape.seq_len, seed=seed,
                    step=step, device=device)
