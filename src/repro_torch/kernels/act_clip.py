"""Fused activation clip + zero count — the SPE clip unit.

One pass over the activations produces (a) the clipped activations
(|x| < tau -> 0, the dynamic activation sparsity of §III) and (b) zero
counts, per tile and for the whole input, which feed the calibration
statistics that drive both the perf model (S_a in Eq. 1) and the
buffer-sizing heuristic — on hardware this is the "dedicated counter" next to
the arbiter in Fig. 3.

On a CUDA tensor the work is done by the hand-written kernel in
``csrc/act_clip_count.cu``; on a CPU tensor by its plain version in ``ref``.
The kernel takes an input of any shape as it lies in memory, without a padded
copy: ``flat_tiles`` says how its n elements are cut into rows and tiles.
``act_clip_count_batched`` is the kernel's batched entry: B proposals'
channel-stacked activations, one tau per proposal read from device memory,
one zero count per proposal.

Each launch counts in ``kernels.launch_counts`` (one key per entry); a launch
made while the current stream captures a CUDA graph counts at every replay
of that graph instead (``kernels.graph.CountedGraph``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build, ref

_FN = {torch.float32: ("hass_act_clip_count_f32", 4),
       torch.bfloat16: ("hass_act_clip_count_bf16", 8)}
_BOUND: dict = {}
#: the batched entry's blocks: at most about this many in all, each with at
#: least one 16-byte vector per thread (the single entry's figures)
_TARGET_BLOCKS, _THREADS = 264, 256


def _fn(dtype, batched: bool = False):
    """(ctypes function, elements per 16-byte vector), looked up once."""
    hit = _BOUND.get((dtype, batched))
    if hit is None:
        if dtype not in _FN:
            raise TypeError(f"act_clip_count takes float32 or bfloat16, "
                            f"got {dtype}")
        name, vec = _FN[dtype]
        if batched:
            name = name.replace("count_", "count_batched_")
        hit = _BOUND[(dtype, batched)] = (getattr(build.lib(), name), vec)
    return hit


def flat_tiles(n: int, bm: int = 256, bn: int = 256) -> Tuple[int, int, int]:
    """How ``ops.act_clip`` views n elements: rows of ``cols = min(n, bn)``
    (the last one may be short), tiles of ``bm_eff = min(bm, rows)`` rows
    (the last one may be short). Returns (cols, bm_eff, tiles)."""
    cols = min(n, bn)
    rows = -(-n // cols)
    bm_eff = min(bm, rows)
    return cols, bm_eff, -(-rows // bm_eff)


def _launch(x, tau, M, N, bm, bn, n_tiles):
    """The kernel on the first ``x.numel()`` elements of an (M, N) view:
    -> (y like x, int32 buffer of n_tiles per-tile counts, the total, the
    blocks' scratch and, last, the ticket word that the launch zeroes)."""
    if not x.is_contiguous():
        raise ValueError("act_clip_count needs a contiguous tensor")
    fn, vec = _fn(x.dtype)
    y = torch.empty_like(x)
    buf = torch.empty((n_tiles * (bm + 1) + 2,), dtype=torch.int32,
                      device=x.device)
    vectorised = int(N % vec == 0 and bn % vec == 0 and
                     x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    with build.device_guard(x):
        err = fn(x.data_ptr(), float(tau), y.data_ptr(), buf.data_ptr(),
                 buf.data_ptr() + 4 * (buf.numel() - 1), x.numel(), M, N,
                 bm, bn, vectorised,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "act_clip_count")
    kernels._count("act_clip_count")
    return y, buf


def act_clip_count_flat(x: torch.Tensor, tau, *, bm: int = 256,
                        bn: int = 256):
    """Any shape -> (clipped x, zero count per tile of ``flat_tiles``
    (elements past the end count as zeros), total zero count as a 0-d int32
    tensor). ``tau`` is a host scalar, rounded to float32 and compared in
    float32."""
    n = x.numel()
    if n == 0:
        raise ValueError("act_clip_count_flat takes a non-empty tensor")
    cols, bm_eff, tiles = flat_tiles(n, bm, bn)
    if x.device.type == "cpu":
        return ref.act_clip_count_flat_ref(x, tau, bm_eff, cols)
    if x.device.type != "cuda":
        raise ValueError(f"act_clip_count runs on cuda or cpu, not {x.device}")
    y, buf = _launch(x, tau, -(-n // cols), cols, bm_eff, cols, tiles)
    return y, buf[:tiles], buf[tiles]


def act_clip_count(x: torch.Tensor, tau, *, bm: int = 256, bn: int = 256):
    """x: (M, N) -> (clipped (M, N), zero count per (bm, bn) tile).

    M, N must be multiples of the block sizes (``act_clip_count_flat`` and
    ``ops.act_clip`` take any shape). ``tau`` is a host scalar; it is rounded
    to float32 and compared in float32.
    """
    if x.dim() != 2:
        raise ValueError(f"act_clip_count takes a 2-D tensor, got {x.shape}")
    M, N = x.shape
    if M == 0 or N == 0 or M % bm or N % bn:
        raise ValueError(f"shape {tuple(x.shape)} is not a multiple of the "
                         f"block ({bm}, {bn})")
    if x.device.type == "cpu":
        return ref.act_clip_count_tiles_ref(x, tau, bm, bn)
    if x.device.type != "cuda":
        raise ValueError(f"act_clip_count runs on cuda or cpu, not {x.device}")
    tiles_m, tiles_n = M // bm, N // bn
    y, buf = _launch(x, tau, M, N, bm, bn, tiles_m * tiles_n)
    return y, buf[:tiles_m * tiles_n].view(tiles_m, tiles_n)


def _batched_plan(R: int, B: int, C: int, vec: int) -> Tuple[int, int]:
    """How the batched entry cuts (R, B, C): (rows per block, blocks per
    proposal). ``vec`` is the elements a thread loads at once (1 when the
    input is not vectorised)."""
    per_row = max(C // vec, 1)
    rows = max(-(-_THREADS // per_row), -(-R // max(1, _TARGET_BLOCKS // B)))
    rows = min(rows, R)
    return rows, -(-R // rows)


def act_clip_count_batched(x: torch.Tensor, taus: torch.Tensor):
    """x: (..., B * C), the activations of B proposals side by side in the
    last dim (proposal b's channels at [b * C, (b + 1) * C)); taus: (B,)
    float32 on x's device -> (clipped x, zero count per proposal, a (B,)
    int32 tensor). One launch for all B; each tau is compared in float32."""
    if not isinstance(taus, torch.Tensor) or taus.dim() != 1 or \
            taus.dtype != torch.float32:
        raise TypeError("act_clip_count_batched takes a (B,) float32 tau "
                        "tensor")
    B = taus.numel()
    if x.dim() == 0 or x.numel() == 0 or B == 0 or x.shape[-1] % B:
        raise ValueError(f"shape {tuple(x.shape)} does not hold {B} "
                         f"proposals side by side in its last dim")
    if taus.device != x.device:
        raise ValueError(f"taus lie on {taus.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.act_clip_count_batched_ref(x, taus)
    if x.device.type != "cuda":
        raise ValueError(f"act_clip_count runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous() or not taus.is_contiguous():
        raise ValueError("act_clip_count_batched needs contiguous tensors")
    fn, vec = _fn(x.dtype, batched=True)
    C = x.shape[-1] // B
    R = x.numel() // x.shape[-1]
    y = torch.empty_like(x)
    vectorised = int(C % vec == 0 and x.data_ptr() % 16 == 0 and
                     y.data_ptr() % 16 == 0)
    rows, parts = _batched_plan(R, B, C, vec if vectorised else 1)
    # B counts, B * parts blocks' words, the ticket word
    buf = torch.empty((B * (parts + 1) + 1,), dtype=torch.int32,
                      device=x.device)
    with build.device_guard(x):
        err = fn(x.data_ptr(), taus.data_ptr(), y.data_ptr(), buf.data_ptr(),
                 buf.data_ptr() + 4 * (buf.numel() - 1), R, B, C, rows,
                 vectorised, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "act_clip_count_batched")
    kernels._count("act_clip_count_batched")
    return y, buf[:B]
