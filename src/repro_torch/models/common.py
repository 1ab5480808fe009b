"""Shared model building blocks (plain functions on tensors)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


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


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


# --------------------------------------------------------------------- #
# Normalization / activations
# --------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps=1e-5) -> torch.Tensor:
    """Normalised in float32 and cast back to the input's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _relu2(x):                                # rwkv channel-mix
    return torch.relu(x).square()


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


# --------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (..., S, 1, D/2) float32, for positions broadcastable
    to (..., S): computed once and shared by every head, layer and tensor
    rotated at those positions."""
    freqs = rope_freqs(d, theta, device=positions.device)      # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: (..., S, H, D). The split-half layout (first half of D paired with
    the second), computed in float32 and cast back."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    return rotate(x, *rope_table(positions, x.shape[-1], theta))


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


def take_layer(stacked, i: int):
    """Slice layer i out of a stacked-parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: take_layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable CE in f32; logits (…, V), labels (…,) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return lse - gold
