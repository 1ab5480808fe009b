"""The numerics of the int8 + error-feedback gradient compression.

Error feedback keeps the quantization bias out of the trajectory (EF-SGD
style): e_{t+1} = x_t + e_t - Q^{-1}(Q(x_t + e_t)). The train step applies
these numerics to its gradients (``TrainConfig.compress_grads``); the
all-reduce that would move the int8 payload between devices
(``compressed_psum`` in the JAX package) belongs to the distribution slice.
"""
from __future__ import annotations

import math

import torch


def quantize_int8(x: torch.Tensor, block: int = 256):
    """(q (blocks, block) int8, scale (blocks, 1) float32, x's shape): per
    block absmax / 127, rounded half to even and clipped to +-127."""
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale, shape


def dequantize_int8(q, scale, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def ef_quantize(x: torch.Tensor, err: torch.Tensor, block: int = 256):
    """Quantize (x + err) to int8; return (dequantized, new_err)."""
    y = x + err
    q, s, shape = quantize_int8(y, block)
    deq = dequantize_int8(q, s, shape)
    return deq, y - deq
