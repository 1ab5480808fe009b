"""Fused activation clip + zero count — the SPE clip unit.

One pass over the activations produces (a) the clipped activations
(|x| < tau -> 0, the dynamic activation sparsity of §III) and (b) per-tile
zero counts, which feed the calibration statistics that drive both the perf
model (S_a in Eq. 1) and the buffer-sizing heuristic — on hardware this is the
"dedicated counter" next to the arbiter in Fig. 3.

On a CUDA tensor the work is done by the hand-written kernel in
``csrc/act_clip_count.cu``; on a CPU tensor by ``ref.act_clip_count_tiles_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: number of kernel launches made by ``act_clip_count`` in this process
launches: int = 0

_FN = {torch.float32: ("hass_act_clip_count_f32", 4),
       torch.bfloat16: ("hass_act_clip_count_bf16", 8)}


def act_clip_count(x: torch.Tensor, tau, *, bm: int = 256, bn: int = 256):
    """x: (M, N) -> (clipped (M, N), zero count per (bm, bn) tile).

    M, N must be multiples of the block sizes (``ops.act_clip`` pads). ``tau``
    is a host scalar; it is rounded to float32 and compared in float32.
    """
    global launches
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
    if x.dtype not in _FN:
        raise TypeError(f"act_clip_count takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("act_clip_count needs a contiguous tensor")
    y = torch.empty_like(x)
    cnt = torch.empty((M // bm, N // bn), dtype=torch.int32, device=x.device)
    name, vec = _FN[x.dtype]
    vectorised = int(N % vec == 0 and bn % vec == 0 and
                     x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    fn = getattr(build.lib(), name)
    with build.device_guard(x):
        err = fn(x.data_ptr(), float(tau), y.data_ptr(), cnt.data_ptr(),
                 M, N, bm, bn, vectorised,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "act_clip_count")
    launches += 1
    return y, cnt
