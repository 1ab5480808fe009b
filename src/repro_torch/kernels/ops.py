"""Public wrappers around the kernels.

Handle padding to block multiples and schedule construction from pruned
weights. The device decides the backend: a CUDA tensor goes through the
hand-written kernel, a CPU tensor through the kernel's plain version.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.act_clip import act_clip_count
from repro_torch.kernels.block_sparse_matmul import (block_sparse_matmul,
                                                     build_tile_schedule)


def _pad_to(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0, p1 = (-x.shape[0]) % m0, (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def weight_tile_mask(w: np.ndarray, bk: int = 128, bn: int = 128) -> np.ndarray:
    """(Kt, Nt) bool: which (bk, bn) tiles of a pruned weight are non-zero."""
    w = np.asarray(w)
    K, N = w.shape
    wp = np.pad(w, ((0, (-K) % bk), (0, (-N) % bn)))
    t = wp.reshape(wp.shape[0] // bk, bk, wp.shape[1] // bn, bn)
    return np.any(t != 0, axis=(1, 3))


class SparseWeight:
    """A pruned weight packaged with its static tile schedule (the paper's
    compile-time arbiter table). Build once after pruning, reuse per step.
    Everything stays on ``w``'s device."""

    def __init__(self, w: torch.Tensor, bk: int = 128, bn: int = 128):
        self.bk, self.bn = bk, bn
        self.shape = tuple(w.shape)
        # bf16 has no numpy dtype; zero / non-zero survives the widening
        mask = weight_tile_mask(w.detach().to("cpu", torch.float32).numpy(),
                                bk, bn)
        counts, indices = build_tile_schedule(mask)
        self.mask = torch.from_numpy(mask).to(w.device)
        self.counts = torch.from_numpy(counts).to(w.device)
        self.indices = torch.from_numpy(indices).to(w.device)
        self.w_padded = _pad_to(w.detach(), bk, bn).contiguous()
        self.tile_density = float(mask.mean())
        #: scheduled (K-tile, column) steps, and what a dense product takes
        self.steps = int(counts.sum())
        self.dense_steps = int(mask.size)

    def matmul(self, x: torch.Tensor, *, bm: int = 128) -> torch.Tensor:
        """x: (M, K) -> (M, N) f32, skipping all-zero weight tiles."""
        M, K = x.shape
        xp = _pad_to(x, bm, self.bk).contiguous()
        out = block_sparse_matmul(xp, self.w_padded, self.counts, self.indices,
                                  bm=bm, bk=self.bk, bn=self.bn)
        return out[:M, :self.shape[1]]


def block_sparse_dense(x, w, *, bm=128, bk=128, bn=128):
    """One-shot convenience: build schedule from w's zeros and multiply."""
    return SparseWeight(w, bk, bn).matmul(x, bm=bm)


def act_clip(x: torch.Tensor, tau, *, bm: int = 256, bn: int = 256):
    """Clip |x| < tau to 0; returns (y, total zero count). Any shape.

    The count is a 0-d integer tensor on ``x``'s device (no host round trip).
    """
    shape = x.shape
    n = x.numel()
    cols = min(n, bn)
    x2 = x.reshape(-1, cols) if n % cols == 0 else \
        F.pad(x.reshape(-1), (0, (-n) % cols)).reshape(-1, cols)
    rows = x2.shape[0]
    bm_eff = min(bm, rows)
    x2 = _pad_to(x2, bm_eff, cols).contiguous()
    y, cnt = act_clip_count(x2, tau, bm=bm_eff, bn=cols)
    pad_zeros = y.numel() - n       # padding contributes zeros to the count
    total = cnt.sum()
    if pad_zeros:
        y, total = y.reshape(-1)[:n], total - pad_zeros
    return y.reshape(shape), total
