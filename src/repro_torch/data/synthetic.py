"""Deterministic synthetic data — images (tokens and frames follow with the
LM families).

Every batch is a pure function of (seed, step), so a restarted job
regenerates exactly the stream it would have seen.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


def _gen(device, seed: int, *xs: int) -> torch.Generator:
    """A generator seeded by (seed, *xs): distinct streams for distinct
    tuples, the same stream for the same tuple."""
    s = seed & 0xFFFFFFFF
    for x in xs:
        s = (s * 0x9E3779B1 + (x & 0xFFFFFFFF) + 0x7F4A7C15) & 0xFFFFFFFFFFFF
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


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
