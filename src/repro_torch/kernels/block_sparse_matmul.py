"""Block-sparse matmul — the SPE arbiter at tile granularity.

The paper's SPE keeps every MAC busy by statically scheduling only non-zero
(weight, activation) pairs (arbiter + zero-filter, Fig. 3). Weight sparsity is
compile-time known, so for every output tile column we *precompute the list of
non-zero K-tiles* and the kernel runs exactly ``nnz`` steps per output tile —
zero tiles are never read from device memory nor multiplied. Eq. 1's
t(S̄)=ceil((1-S̄)M/N) becomes ``steps = nnz_tiles(column)`` with M/N = K/bk
tiles.

The schedule (counts, indices) is the arbiter. On a CUDA tensor the product is
the hand-written kernel in ``csrc/block_sparse_matmul.cu``, run under a work
plan (``make_plan``): an output tile and a split of each column's scheduled
K-tiles into step ranges, so that the launch fills the card's SMs. On a CPU
tensor it is ``ref.block_sparse_matmul_ref`` on the mask the schedule encodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build, ref


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


#: streaming multiprocessors of an H100 SXM: the plan's unit of parallelism
N_SM = 132
#: output tiles (rows, columns) the kernel is built for
TILES = ((128, 64), (64, 128), (16, 128))
#: depth of the kernel's chunk: the unit in which a plan splits a column
CHUNK = 16


@dataclasses.dataclass(frozen=True)
class WorkPlan:
    """How one launch covers ``x (M, K) @ w (K, N)`` under a schedule.

    ``items[b] = (m_tile, n_tile, c0, c1, slot)``: block b computes output
    rows ``m_tile * tile[0] + [0, tile[0])`` and columns ``n_tile * tile[1] +
    [0, tile[1])`` over chunks ``[c0, c1)`` of their schedule column ``j``
    (chunk c is the ``CHUNK`` rows ``(c % cpt) * CHUNK`` of K-tile
    ``indices[j, c // cpt]``, ``cpt = bk // CHUNK``), into workspace slab
    ``slot``. ``splits[j]`` is the number of pieces (slabs) of column ``j``;
    with ``max_splits == 1`` the items write the output directly.
    ``promised`` is the block count the plan guarantees: half its
    ``target``, or every piece of two chunks where the schedule has fewer."""
    M: int
    N: int
    tile: Tuple[int, int]
    items: np.ndarray
    splits: np.ndarray
    target: int
    promised: int

    @property
    def blocks(self) -> int:
        return int(self.items.shape[0])

    @property
    def max_splits(self) -> int:
        return int(self.splits.max())


def choose_tile(M: int) -> Tuple[int, int]:
    """The output tile for M rows: 16 x 128 for a handful (the classifier's
    batch), 128 x 64 from 4096 rows, else 64 x 128. (Measured on the H100,
    ``tools/kernel_sweep_torch.py``: the two 128-thread tiles beat 128 x 128
    at every product shape of the main path.)"""
    if M <= 16:
        return 16, 128
    return (128, 64) if M >= 4096 else (64, 128)


def make_plan(counts: np.ndarray, M: int, N: int, *, bk: int = 128,
              bn: int = 128, tile: Optional[Tuple[int, int]] = None,
              target: Optional[int] = None, min_chunks: int = 8
              ) -> WorkPlan:
    """Cut the product into about ``target`` work items: by default 2 per SM
    from 4096 rows (there a split's f32 slab of the output, written and read
    again, costs most) and 4 per SM below. Where the output tiles alone are
    fewer, each schedule column's ``counts[j] * bk / CHUNK`` chunks are split
    into contiguous, near-equal ranges of at least ``min_chunks`` chunks, or
    where pieces that long would leave fewer than ``target // 2`` items, of
    the most chunks (2 at the least) that give that many. A column with no steps gets one empty item, which writes its
    zeros. Items with a split are ordered longest first, so that the last
    wave holds the short ones."""
    if bk % CHUNK:
        raise ValueError(f"bk={bk} is not a multiple of {CHUNK}")
    counts = np.asarray(counts, dtype=np.int64) * (bk // CHUNK)
    BM, BN = tile or choose_tile(M)
    if (BM, BN) not in TILES or bn % BN:
        raise ValueError(f"tile {(BM, BN)} is not one of {TILES} dividing "
                         f"bn={bn}")
    tm, tn = -(-M // BM), -(-N // BN)
    col = np.arange(tn) * BN // bn                # schedule column per n-tile
    if col[-1] >= counts.shape[0]:
        raise ValueError(f"{counts.shape[0]} schedule columns do not cover "
                         f"N={N} at bn={bn}")
    if target is None:
        target = N_SM * (2 if M >= 4096 else 4)

    def n_items(spi):
        return tm * int(np.maximum(1, -(-counts[col] // spi)).sum())

    if tm * tn >= target:
        pieces = np.ones_like(counts)
    else:
        spi = max(1, int(tm * counts[col].sum()) // target)
        if spi < min_chunks:    # the longest pieces that still give half
            spi = next((c for c in range(min_chunks, 2, -1)
                        if n_items(c) >= target // 2), 2)
        pieces = np.maximum(1, -(-counts // spi))
    rows = []
    for m in range(tm):
        for n in range(tn):
            j, p = col[n], pieces[col[n]]
            bounds = np.arange(p + 1) * counts[j] // p
            rows.extend((m, n, int(bounds[s]), int(bounds[s + 1]), s)
                        for s in range(p))
    items = np.asarray(rows, dtype=np.int32).reshape(-1, 5)
    if pieces.max() > 1:
        items = items[np.argsort(items[:, 2] - items[:, 3], kind="stable")]
    return WorkPlan(M=M, N=N, tile=(BM, BN), items=np.ascontiguousarray(items),
                    splits=pieces.astype(np.int32), target=target,
                    promised=min(target // 2, n_items(2)))


_FN = {torch.float32: "hass_block_sparse_matmul_f32",
       torch.bfloat16: "hass_block_sparse_matmul_bf16"}
_BOUND: dict = {}


class DevicePlan:
    """A ``WorkPlan`` with its items and splits on the card."""

    def __init__(self, plan: WorkPlan, device):
        self.plan = plan
        self.items = torch.from_numpy(plan.items).to(device)
        self.splits = torch.from_numpy(plan.splits).to(device)


def _fn(dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        if dtype not in _FN:
            raise TypeError(f"block_sparse_matmul takes float32 or bfloat16, "
                            f"got {dtype}")
        fn = _BOUND[dtype] = getattr(build.lib(), _FN[dtype])
    return fn


def run_plan(x: torch.Tensor, w: torch.Tensor, indices: torch.Tensor,
             dplan: DevicePlan, N: int, *, bk: int = 128, bn: int = 128
             ) -> torch.Tensor:
    """The kernel: ``x (M, K) @ w[:K, :N]`` under ``dplan``. ``x`` is taken
    as it is (any M and K, no padded copy); ``w`` is the weight padded to
    whole (bk, bn) tiles. Returns a new f32 (M, N)."""
    M, K = x.shape
    plan = dplan.plan
    if plan.M != M or plan.N != N:
        raise ValueError(f"the plan is for M={plan.M}, N={plan.N}; "
                         f"got M={M}, N={N}")
    for name, t in (("w", w), ("indices", indices), ("the plan", dplan.items),
                    ("the plan's splits", dplan.splits)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on cuda, not {x.device}")
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype} but w is {w.dtype}")
    fn = _fn(x.dtype)
    if w.shape[0] < K or w.shape[0] % bk or w.shape[1] % bn or \
            w.shape[1] < N:
        raise ValueError(f"w {tuple(w.shape)} is not padded to whole "
                         f"({bk}, {bn}) tiles over K={K}, N={N}")
    if not (x.is_contiguous() and w.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError("block_sparse_matmul needs contiguous tensors")
    if w.data_ptr() % 16:
        raise ValueError("block_sparse_matmul needs a 16-byte aligned w")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((plan.max_splits, M, N), dtype=torch.float32,
                      device=x.device) if plan.max_splits > 1 else None)
    with build.device_guard(x):
        err = fn(x.data_ptr(), w.data_ptr(), indices.data_ptr(),
                 dplan.items.data_ptr(), dplan.splits.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 M, K, N, w.shape[1], bk, bn, indices.shape[1], plan.blocks,
                 plan.tile[0], plan.tile[1], plan.max_splits,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "block_sparse_matmul")
    kernels._count("block_sparse_matmul")
    return out


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, indices: torch.Tensor,
                        *, bm: int = 128, bk: int = 128, bn: int = 128
                        ) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) skipping all-zero weight tiles.

    counts/indices from ``build_tile_schedule`` (int32 tensors on x's device).
    M, K, N must be multiples of the block sizes, as for the TPU kernel
    (``ops.SparseWeight`` takes any shape). Returns f32 (M, N). The schedule
    is trusted: an index past K/bk reads out of bounds, as it would on any
    device.
    """
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
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype} but w is {w.dtype}")
    if x.device.type == "cpu":
        mask = schedule_mask(counts.numpy(), indices.numpy(), K // bk)
        return ref.block_sparse_matmul_ref(x, w, torch.from_numpy(mask),
                                           bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on cuda or cpu, "
                         f"not {x.device}")
    for name, t in (("w", w), ("counts", counts), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if counts.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("counts and indices must be int32")
    # the plan needs the counts on the host (SparseWeight keeps its plans)
    plan = make_plan(counts.cpu().numpy(), M, N, bk=bk, bn=bn)
    return run_plan(x, w, indices, DevicePlan(plan, x.device), N, bk=bk,
                    bn=bn)
