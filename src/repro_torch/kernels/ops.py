"""Public wrappers around the kernels.

Any-shape entry points and schedule construction from pruned weights. The
device decides the backend: a CUDA tensor goes through the hand-written
kernel, which takes the operand as it lies (no padded copy), a CPU tensor
through the kernel's plain version. ``conv_igemm`` is the grouped
convolution of the batched CNN forward (``kernels.conv_igemm``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.act_clip import (act_clip_count_batched,
                                         act_clip_count_flat)
from repro_torch.kernels.block_sparse_matmul import (DevicePlan,
                                                     build_tile_schedule,
                                                     make_plan, run_plan)
from repro_torch.kernels.conv_igemm import conv_igemm


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
    compile-time arbiter table) and, per row count M, the kernel's work plan
    (``make_plan``). Build once after pruning, reuse per step. Everything
    stays on ``w``'s device."""

    def __init__(self, w: torch.Tensor, bk: int = 128, bn: int = 128):
        self.bk, self.bn = bk, bn
        self.shape = tuple(w.shape)
        # bf16 has no numpy dtype; zero / non-zero survives the widening
        mask = weight_tile_mask(w.detach().to("cpu", torch.float32).numpy(),
                                bk, bn)
        counts, indices = build_tile_schedule(mask)
        #: the schedule's counts on the host, from which plans are made
        self.host_counts = counts
        self.mask = torch.from_numpy(mask).to(w.device)
        self.counts = torch.from_numpy(counts).to(w.device)
        self.indices = torch.from_numpy(indices).to(w.device)
        self.w_padded = _pad_to(w.detach(), bk, bn).contiguous()
        self.tile_density = float(mask.mean())
        #: scheduled (K-tile, column) steps, and what a dense product takes
        self.steps = int(counts.sum())
        self.dense_steps = int(mask.size)
        self._plans: dict = {}

    def plan(self, M: int) -> DevicePlan:
        """The work plan for M rows, built on first use and kept."""
        dplan = self._plans.get(M)
        if dplan is None:
            dplan = self._plans[M] = DevicePlan(
                make_plan(self.host_counts, M, self.shape[1], bk=self.bk,
                          bn=self.bn),
                self.w_padded.device)
        return dplan

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x: (M, K) -> (M, N) f32, skipping all-zero weight tiles."""
        M, K = x.shape
        if K != self.shape[0]:
            raise ValueError(f"x has K={K}, the weight {self.shape}")
        if x.device.type == "cpu":
            return ref.block_sparse_matmul_ref(
                x, self.w_padded[:K, :self.shape[1]], self.mask.cpu(),
                self.bk, self.bn)
        return run_plan(x, self.w_padded, self.indices, self.plan(M),
                        self.shape[1], bk=self.bk, bn=self.bn)


def block_sparse_dense(x, w, *, bk=128, bn=128):
    """One-shot convenience: build schedule from w's zeros and multiply."""
    return SparseWeight(w, bk, bn).matmul(x)


def act_clip(x: torch.Tensor, tau, *, bm: int = 256, bn: int = 256):
    """Clip |x| < tau to 0; returns (y, total zero count). Any shape.

    The count is a 0-d int32 tensor on ``x``'s device (no host round trip).
    On the card this is one kernel launch on ``x`` as it lies (after a
    4-byte memset of the launch's ticket word).
    """
    y, _, total = act_clip_count_flat(x, tau, bm=bm, bn=bn)
    return y, total


#: The clip of B proposals at once: ``x``'s last dim holds their channels
#: side by side (B * C), ``taus`` one float32 tau each on ``x``'s device ->
#: (y, zero count per proposal). On the card one launch of the kernel's
#: batched entry, which reads the taus where they lie: a captured CUDA graph
#: clips each replay at that replay's taus.
act_clip_batched = act_clip_count_batched

