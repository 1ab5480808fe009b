"""Block-sparse matmul — the SPE arbiter at tile granularity.

The paper's SPE keeps every MAC busy by statically scheduling only non-zero
(weight, activation) pairs (arbiter + zero-filter, Fig. 3). Weight sparsity is
compile-time known, so for every output tile column we *precompute the list of
non-zero K-tiles* and the kernel runs exactly ``nnz`` steps per output tile —
zero tiles are never read from device memory nor multiplied. Eq. 1's
t(S̄)=ceil((1-S̄)M/N) becomes ``steps = nnz_tiles(column)`` with M/N = K/bk
tiles.

The schedule (counts, indices) is the arbiter. On a CUDA tensor the product is
the hand-written kernel in ``csrc/block_sparse_matmul.cu`` (one block per
128 x 128 piece of the output, the loop over the scheduled K-tiles inside the
block); on a CPU tensor it is ``ref.block_sparse_matmul_ref`` on the mask the
schedule encodes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

#: number of kernel launches made by ``block_sparse_matmul`` in this process
launches: int = 0


def _build_tile_schedule_ref(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference per-column-loop schedule builder — kept as the equivalence
    oracle for the vectorized path (tests, kernels_bench)."""
    mask = np.asarray(mask, dtype=bool)
    Kt, Nt = mask.shape
    counts = mask.sum(axis=0).astype(np.int32)
    max_nnz = max(1, int(counts.max()) if counts.size else 1)
    indices = np.zeros((Nt, max_nnz), dtype=np.int32)
    for j in range(Nt):
        nz = np.nonzero(mask[:, j])[0]
        indices[j, :len(nz)] = nz
    return counts, indices


def tile_mask(w: np.ndarray, bk: int = 128, bn: int = 128) -> np.ndarray:
    """(K, N) weight -> (Kt, Nt) bool map of tiles with any non-zero entry.

    The bridge from a pruned weight to ``build_tile_schedule``: pattern
    pruning (tile / N:M / hierarchical, DESIGN.md §16) produces element
    zeros; the kernel skips at tile granularity, so only tiles
    that pruning emptied *entirely* shorten the schedule.
    """
    w = np.asarray(w)
    K, N = w.shape
    assert K % bk == 0 and N % bn == 0, (w.shape, bk, bn)
    t = w.reshape(K // bk, bk, N // bn, bn)
    return (t != 0).any(axis=(1, 3))


# schedule memo: a weight is pruned once and multiplied every step, and
# several layers often share one mask shape+pattern (tile-structured
# pruning is deterministic), so schedules are cached per mask content
_SCHEDULE_CACHE: dict = {}
_SCHEDULE_CACHE_MAX = 256


def build_tile_schedule(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """mask: (Kt, Nt) bool -> (counts (Nt,), indices (Nt, max_nnz)) int32.

    indices[j, s] is the K-tile id of the s-th non-zero tile in column j
    (padded with 0 past counts[j]; padded steps are masked in the kernel).
    This is the compile-time static schedule — the paper's arbiter, resolved
    ahead of time because weight sparsity is known at compile time (§III).

    Vectorized: one ``np.nonzero`` over the transposed mask yields every
    (column, K-tile) pair in column-major order, and a cumsum of the
    per-column counts scatters each pair into its step slot — O(nnz) flat
    numpy instead of the reference's per-column Python loop. Results are
    memoized on the mask bytes — rebuilding the schedule for an unchanged
    weight is a dict hit (``kernels_bench.py`` gates both).
    """
    mask = np.asarray(mask, dtype=bool)
    key = (mask.shape, mask.tobytes())
    hit = _SCHEDULE_CACHE.get(key)
    if hit is not None:
        return hit
    Kt, Nt = mask.shape
    if Kt == 0 or Nt == 0:
        return _build_tile_schedule_ref(mask)
    counts = mask.sum(axis=0).astype(np.int32)
    max_nnz = max(1, int(counts.max()) if counts.size else 1)
    flat = np.flatnonzero(np.ascontiguousarray(mask.T))
    cols, rows = np.divmod(flat, Kt)     # column-major: ascending rows
    starts = np.zeros(Nt, dtype=np.int64)     # within each column
    starts[1:] = np.cumsum(counts[:-1])
    slot = np.arange(len(rows), dtype=np.int64) - starts[cols]
    indices = np.zeros((Nt, max_nnz), dtype=np.int32)
    indices[cols, slot] = rows
    if len(_SCHEDULE_CACHE) >= _SCHEDULE_CACHE_MAX:
        _SCHEDULE_CACHE.clear()
    out = (counts, indices)
    _SCHEDULE_CACHE[key] = out
    return out


def schedule_mask(counts: np.ndarray, indices: np.ndarray, Kt: int
                  ) -> np.ndarray:
    """Inverse of ``build_tile_schedule``: (Kt, Nt) bool mask of the tiles a
    schedule visits."""
    counts = np.asarray(counts)
    indices = np.asarray(indices)
    Nt = counts.shape[0]
    mask = np.zeros((Kt, Nt), dtype=bool)
    for j in range(Nt):
        mask[indices[j, :counts[j]], j] = True
    return mask


_FN = {torch.float32: "hass_block_sparse_matmul_f32",
       torch.bfloat16: "hass_block_sparse_matmul_bf16"}
#: the kernel's fixed output piece per block, and the depth of a staged chunk
_TM, _TN, _TK = 128, 128, 16


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, indices: torch.Tensor,
                        *, bm: int = 128, bk: int = 128, bn: int = 128
                        ) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) skipping all-zero weight tiles.

    counts/indices from ``build_tile_schedule`` (int32 tensors on x's device).
    M, K, N must be multiples of the block sizes (``ops.block_sparse_dense``
    pads). Returns f32 (M, N). The schedule is trusted: an index past K/bk
    reads out of bounds, as it would on any device.
    """
    global launches
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"2-D operands expected, got {x.shape}, {w.shape}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or M % bm or K % bk or N % bn or min(M, K, N) == 0:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not "
                         f"fit blocks ({bm}, {bk}, {bn})")
    Nt = N // bn
    if indices.dim() != 2 or counts.shape != (Nt,) or indices.shape[0] != Nt:
        raise ValueError(f"schedule shapes {tuple(counts.shape)}, "
                         f"{tuple(indices.shape)} do not fit {Nt} columns")
    max_nnz = indices.shape[1]
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype} but w is {w.dtype}")
    if x.device.type == "cpu":
        mask = schedule_mask(counts.numpy(), indices.numpy(), K // bk)
        return ref.block_sparse_matmul_ref(x, w, torch.from_numpy(mask),
                                           bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on cuda or cpu, "
                         f"not {x.device}")
    if x.dtype not in _FN:
        raise TypeError(f"block_sparse_matmul takes float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, t in (("w", w), ("counts", counts), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if counts.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("counts and indices must be int32")
    if not (x.is_contiguous() and w.is_contiguous()
            and counts.is_contiguous() and indices.is_contiguous()):
        raise ValueError("block_sparse_matmul needs contiguous tensors")
    if M % _TM or bn % _TN or bk % _TK or max_nnz < 1:
        raise ValueError(
            f"the kernel takes M % {_TM} == 0, bn % {_TN} == 0 and "
            f"bk % {_TK} == 0; got M={M}, bk={bk}, bn={bn}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("block_sparse_matmul needs 16-byte aligned operands")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    fn = getattr(build.lib(), _FN[x.dtype])
    with build.device_guard(x):
        err = fn(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                 indices.data_ptr(), out.data_ptr(), M, K, N, bk, bn,
                 max_nnz, torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_sparse_matmul")
    launches += 1
    return out
