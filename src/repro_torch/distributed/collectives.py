"""Distributed-optimization collectives: int8 + error-feedback gradient
compression.

Error feedback keeps the quantization bias out of the trajectory (EF-SGD
style): e_{t+1} = x_t + e_t - Q^{-1}(Q(x_t + e_t)). The train step applies
the numerics to its gradients (``TrainConfig.compress_grads``);
``compressed_psum`` is the all-reduce over a mesh dimension.
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


def compressed_psum(x: torch.Tensor, err: torch.Tensor, mesh,
                    axis: str = "data", block: int = 256):
    """Mean-all-reduce of each rank's contribution with int8 quantisation +
    error feedback over the ``axis`` dimension of ``mesh``.

    x, err: this rank's local gradient and error (row i of the reference's
    stacked (n, *shape) inputs). Returns (mean, new_err): the mean, the same
    on every rank, and this rank's new error. What enters the all-reduce is
    the dequantised float32 value (exactly the int8-representable payload
    q * s), as the reference's ``psum`` sums it; neither package moves int8
    over the wire.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    deq, new_err = ef_quantize(x, err, block)
    total = deq.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / dist.get_world_size(group), new_err
