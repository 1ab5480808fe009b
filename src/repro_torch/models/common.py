"""Shared model building blocks (plain functions on tensors)."""
from __future__ import annotations

import math
from typing import Optional

import torch


# --------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, in_axis=-2, scale=1.0,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """LeCun-normal over the contracted axis; stored in float32, cast at use.

    Drawn from ``gen`` on the generator's device and then moved to ``device``
    (the card, unless the caller asks for ``"cpu"``), so one seed gives one
    set of weights wherever they end up."""
    fan_in = shape[in_axis]
    std = scale / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) * std
    return w.to(device=device, dtype=dtype)


# --------------------------------------------------------------------- #
# Activation clipping — the paper's SPE "clip" unit (§IV).
# Values with |x| < tau are zeroed at run time (dynamic activation sparsity).
# --------------------------------------------------------------------- #
def act_clip(x: torch.Tensor, tau) -> torch.Tensor:
    """tau: scalar or per-layer scalar. ``None`` disables (identity)."""
    if tau is None:
        return x
    if not isinstance(tau, torch.Tensor):
        tau = torch.tensor(float(tau), dtype=x.dtype, device=x.device)
    return torch.where(x.abs() >= tau, x, torch.zeros_like(x))


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable CE in f32; logits (…, V), labels (…,) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return lse - gold
