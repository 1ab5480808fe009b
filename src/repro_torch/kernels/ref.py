"""The plain PyTorch version of every kernel (the comparison targets).

Used by the CPU tests, by the wrappers for a tensor that lies on the CPU, and
by the on-card comparison of each kernel; never on the main path when the
tensor is on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def act_clip_count_flat_ref(x: torch.Tensor, tau, bm: int, cols: int):
    """Any shape, taken as rows of ``cols`` elements in tiles of ``bm`` rows
    (the kernel's view, ``act_clip.flat_tiles``) -> (clipped x, zero count
    per tile with the elements past the end counted as zeros, total zero
    count as a 0-d int32 tensor): the kernel's own outputs."""
    y = act_clip_ref(x, tau)
    z = (y == 0).reshape(-1).to(torch.int32)
    tile = bm * cols
    n_tiles = -(-z.numel() // tile)
    padded = torch.nn.functional.pad(z, (0, n_tiles * tile - z.numel()),
                                     value=1)
    return y, padded.reshape(n_tiles, tile).sum(1, dtype=torch.int32), \
        z.sum(dtype=torch.int32)


def act_clip_count_batched_ref(x: torch.Tensor, taus: torch.Tensor):
    """x: (..., B * C), the channels of B proposals side by side in its last
    dim; taus: (B,) -> (clipped x, zero count per proposal as a (B,) int32
    tensor): the batched entry's own outputs. Proposal b's elements, the
    columns [b * C, (b + 1) * C) of every row, are clipped at taus[b] (in
    float32, as ``act_clip_ref``)."""
    B = taus.numel()
    xs = x.reshape(-1, B, x.shape[-1] // B)
    keep = xs.to(torch.float32).abs() >= \
        taus.to(device=x.device, dtype=torch.float32).reshape(1, B, 1)
    y = torch.where(keep, xs, torch.zeros_like(xs))
    return y.reshape(x.shape), (y == 0).sum(dim=(0, 2), dtype=torch.int32)


def block_sparse_matmul_plan_ref(x: torch.Tensor, w: torch.Tensor,
                                 indices, items, splits, tile, N: int,
                                 bk: int, bn: int, chunk: int = 16
                                 ) -> torch.Tensor:
    """The kernel's work plan executed chunk by chunk in float32: each item
    ``(m_tile, n_tile, c0, c1, slot)`` sums its ``chunk``-deep pieces of the
    scheduled K-tiles into slab ``slot``, then the slabs of each schedule
    column are added in slot order (as the kernel's reduction does). ``w``
    may be padded past (K, N)."""
    M, K = x.shape
    BM, BN = tile
    cpt = bk // chunk
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    ws = torch.zeros((int(max(splits)), M, N), dtype=torch.float32)
    for m_t, n_t, c0, c1, slot in (tuple(int(v) for v in r) for r in items):
        r0, r1 = m_t * BM, min(M, (m_t + 1) * BM)
        n0, n1 = n_t * BN, min(N, (n_t + 1) * BN)
        acc = torch.zeros((r1 - r0, n1 - n0), dtype=torch.float32)
        for c in range(c0, c1):
            k0 = int(indices[n0 // bn, c // cpt]) * bk + (c % cpt) * chunk
            k1 = min(K, k0 + chunk)
            if k0 < k1:
                acc += xf[r0:r1, k0:k1] @ wf[k0:k1, n0:n1]
        ws[slot, r0:r1, n0:n1] = acc
    out = ws[0].clone()
    for j, p in enumerate(int(v) for v in splits):
        cols = slice(j * bn, min(N, (j + 1) * bn))
        for s in range(1, p):
            out[:, cols] += ws[s, :, cols]
    return out


def conv_igemm_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   stride: int, relu: bool, pad: int) -> torch.Tensor:
    """x: NHWC (N, H, W, B * cin); w: (B, k, k, cin, cout), the B groups'
    weights; bias: (cout,), shared -> NHWC (N, Ho, Wo, B * cout), group b's
    outputs at [b * cout, (b + 1) * cout), padding ``pad`` on every side:
    the kernel's function, as the batched forward ran it before the kernel.
    The B weights copied into one HWIO weight of B * cout outputs, one
    grouped convolution on channels-first views, the bias repeated B times,
    then relu or nothing."""
    B, k, _, cin, cout = w.shape
    hwio = w.permute(1, 2, 3, 0, 4).reshape(k, k, cin, B * cout)
    y = F.conv2d(x.permute(0, 3, 1, 2), hwio.permute(3, 2, 0, 1), None,
                 stride=stride, padding=pad, groups=B)
    y = y.permute(0, 2, 3, 1).contiguous() + bias.repeat(B)
    return F.relu(y) if relu else y
