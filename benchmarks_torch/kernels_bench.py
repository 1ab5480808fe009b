"""Kernel microbenchmarks of the port: the schedule memo gate, then
``SparseWeight.matmul`` at tile densities 1.0 / 0.5 / 0.25 and ``act_clip``
at 512 x 512.

On the card these are the hand-written CUDA kernels
(``block_sparse_matmul``, ``act_clip_count``), timed with CUDA events
(``bench_util.time_ms``: the eager call, its host cost included) and held
against their plain PyTorch versions; on the CPU they are the plain versions
themselves, timed by the host clock. ``grid_steps`` (scheduled tile steps
x row blocks, Eq. 1 at tile granularity) is the JAX script's count.

    python -m benchmarks_torch.kernels_bench [--device cpu --out-dir DIR]
"""
import time

import numpy as np
import torch

from benchmarks_torch.common import emit, save_json, target, timed
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_sparse_matmul import (_SCHEDULE_CACHE,
                                                     _build_tile_schedule_ref,
                                                     build_tile_schedule)


def bench_schedule(seed: int = 0):
    """Schedule build (vectorized vs per-column-loop reference) and reuse
    (mask-hash memo hit) — the compile-time arbiter cost per pruned weight."""
    rng = np.random.default_rng(seed)
    rows = []
    for kt, nt, density in ((56, 56, 0.5), (112, 112, 0.25)):
        mask = rng.random((kt, nt)) < density
        c_ref, i_ref = _build_tile_schedule_ref(mask)
        _SCHEDULE_CACHE.clear()
        t0 = time.perf_counter()
        c, i = build_tile_schedule(mask)
        t_cold = time.perf_counter() - t0
        assert np.array_equal(c, c_ref) and np.array_equal(i, i_ref)
        t0 = time.perf_counter()
        reps = 50
        for _ in range(reps):
            build_tile_schedule(mask)
        t_hit = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        _build_tile_schedule_ref(mask)
        t_ref = time.perf_counter() - t0
        emit(f"kernel.schedule.{kt}x{nt}", t_cold * 1e6,
             f"ref={t_ref * 1e6:.0f}us memo_hit={t_hit * 1e6:.1f}us "
             f"(reuse {t_ref / max(t_hit, 1e-9):.0f}x)")
        assert t_hit < t_ref, "schedule memo regressed: hit slower than ref"
        rows.append({"mask": [kt, nt], "cold_us": t_cold * 1e6,
                     "memo_hit_us": t_hit * 1e6, "ref_us": t_ref * 1e6})
    return rows


def _call_us(fn, dev) -> float:
    """Microseconds per eager call: CUDA events on the card, the host clock
    (three calls after a warm-up) on the CPU."""
    if dev.type == "cuda":
        from repro_torch.kernels.bench_util import time_ms
        return time_ms(fn) * 1e3
    fn()
    return timed(fn, repeat=3)[1]


def run(seed: int = 0, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    schedule = bench_schedule(seed)
    rng = np.random.default_rng(seed)
    M = K = N = 256
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    bsmm = []
    for tile_density in (1.0, 0.5, 0.25):
        w = rng.normal(size=(K, N)).astype(np.float32)
        Kt, Nt = K // 128, N // 128
        keep = rng.random((Kt, Nt)) < tile_density
        if not keep.any():
            keep[0, 0] = True
        for i in range(Kt):
            for j in range(Nt):
                if not keep[i, j]:
                    w[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = 0.0
        wt = torch.from_numpy(w).to(dev)
        sw = ops.SparseWeight(wt)
        out = sw.matmul(x)
        want = ref.block_sparse_matmul_ref(x, wt, sw.mask, 128, 128)
        err = float((out - want).abs().max())
        # unit-normal operands at K = 256, as the reference's kernel tests
        assert torch.allclose(out, want, atol=1e-4, rtol=1e-4), \
            f"block_sparse_matmul != plain at density {tile_density}: {err}"
        us = _call_us(lambda: sw.matmul(x), dev)
        steps = int(sw.host_counts.sum()) * (M // 128)
        dense_steps = Kt * Nt * (M // 128)
        emit(f"kernel.bsmm.density{tile_density}", us,
             f"grid_steps={steps}/{dense_steps} "
             f"(skip={(1 - steps / dense_steps):.0%})")
        bsmm.append({"tile_density": tile_density, "us": us,
                     "grid_steps": steps, "dense_steps": dense_steps,
                     "max_abs_err": err})

    a = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32)) \
        .to(dev)
    y, cnt = ops.act_clip(a, 0.5)
    y_ref, cnt_ref = ref.act_clip_count_ref(a, 0.5)
    assert torch.equal(y, y_ref) and int(cnt) == int(cnt_ref), \
        "act_clip_count != plain at 512 x 512"
    us = _call_us(lambda: ops.act_clip(a, 0.5)[0], dev)
    emit("kernel.act_clip.512x512", us, "fused clip+count, one pass")
    payload = {"schedule": schedule, "bsmm": bsmm,
               "act_clip": {"shape": [512, 512], "us": us,
                            "zeros": int(cnt)},
               "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    save_json("kernels_bench", payload, dev, out_dir)
    return payload


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(device=args.device, out_dir=args.out_dir)
