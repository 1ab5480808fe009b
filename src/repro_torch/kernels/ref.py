"""The plain PyTorch version of every kernel (the comparison targets).

Used by the CPU tests, by the wrappers for a tensor that lies on the CPU, and
by the on-card comparison of each kernel; never on the main path when the
tensor is on the card.
"""
from __future__ import annotations

import torch


def expand_tile_mask(mask: torch.Tensor, bk: int, bn: int,
                     K: int, N: int) -> torch.Tensor:
    """(K/bk, N/bn) bool tile mask -> (K, N) elementwise mask."""
    m = mask.repeat_interleave(bk, dim=0).repeat_interleave(bn, dim=1)
    return m[:K, :N]


def block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                            mask: torch.Tensor, bk: int, bn: int
                            ) -> torch.Tensor:
    """x: (M, K); w: (K, N); mask: (ceil(K/bk), ceil(N/bn)) bool -> f32.

    Semantics of the kernel: tiles with mask==False contribute exactly zero
    (they are never loaded), regardless of w's contents there. Inputs are
    widened to float32 and the product is accumulated in float32.
    """
    K, N = w.shape
    keep = expand_tile_mask(mask.to(w.device), bk, bn, K, N)
    wm = torch.where(keep, w, torch.zeros_like(w))
    return x.to(torch.float32) @ wm.to(torch.float32)


def act_clip_ref(x: torch.Tensor, tau) -> torch.Tensor:
    """Zero out |x| < tau (the SPE clip unit).

    The compare is made in float32 after widening ``x``, with ``tau`` rounded
    to float32 — as the kernel does, and as the TPU kernel does (its ``tau``
    is a float32 scalar, so a bf16 ``x`` promotes). For float32 inputs this
    is the ordinary compare.
    """
    tau32 = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    return torch.where(x.to(torch.float32).abs() >= tau32, x,
                       torch.zeros_like(x))


def act_clip_count_ref(x: torch.Tensor, tau):
    """-> (clipped x, total count of zeros in it as an int32 scalar)."""
    y = act_clip_ref(x, tau)
    return y, (y == 0).sum().to(torch.int32)


def act_clip_count_tiles_ref(x: torch.Tensor, tau, bm: int, bn: int):
    """x: (M, N) -> (clipped (M, N), zero count per (bm, bn) tile, int32):
    the kernel's own outputs."""
    M, N = x.shape
    y = act_clip_ref(x, tau)
    cnt = (y == 0).reshape(M // bm, bm, N // bn, bn).sum(dim=(1, 3))
    return y, cnt.to(torch.int32)
