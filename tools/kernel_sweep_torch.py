"""Sweep the work plans of the port's ``block_sparse_matmul`` kernel on an
NVIDIA GPU, and time ``act_clip_count`` on the ResNet-18 stats forward's
inputs.

    python3 tools/kernel_sweep_torch.py [--quick]

For every distinct product shape of ``chip_smoke.py``'s execute step (random
schedules at 60 % tile density, seeded) it times each candidate plan
(tile x min_chunks x target items, duplicates dropped) in a CUDA graph beside
the dense library product, and prints one JSON line per shape with the best
plan and what ``make_plan`` picks by default. It also prints the
compiler's register and spill report for each kernel. Needs one card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.kernels import bench_util as bu  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as bsm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

SHAPES = sorted({(M, K, N) for M, K, N in [
    (25088, 147, 64), (25088, 576, 64), (6272, 576, 128), (6272, 1152, 128),
    (6272, 64, 128), (1568, 1152, 256), (1568, 2304, 256), (1568, 128, 256),
    (392, 2304, 512), (392, 4608, 512), (392, 256, 512), (8, 512, 1000),
    (6272, 2304, 256)]})


def ptxas_report() -> list:
    path = os.path.join(build.build_dir(), "build.log")
    if not os.path.exists(path):
        return ["build.log not found (library was already built)"]
    keep = []
    for line in open(path):
        if re.search(r"Compiling entry|registers|spill", line):
            keep.append(line.strip())
    return keep


def sweep_matmul(quick: bool) -> None:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    dev = torch.device("cuda")
    for (M, K, N) in SHAPES:
        density = 1.0 if (M, K, N) == (6272, 2304, 256) else 0.6
        x = torch.randn((M, K), generator=gen).to(dev)
        w = bu.tile_sparse_weight(K, N, density, gen).to(dev)
        sw = ops.SparseWeight(w)
        wm = sw.w_padded[:K, :N].contiguous()
        want = x @ wm
        counts = sw.counts.cpu().numpy()
        default = bsm.make_plan(counts, M, N)
        seen, rows = set(), []
        tiles = [t for t in bsm.TILES if M <= 1568 or t[0] > 16]
        for tile in tiles:
            for min_chunks in ((2, 8) if quick else (2, 4, 8, 16)):
                for tgt in ((264, 528) if quick else (132, 264, 528, 1056)):
                    p = bsm.make_plan(counts, M, N, tile=tile,
                                      min_chunks=min_chunks, target=tgt)
                    key = (p.tile, p.items.tobytes())
                    if key in seen:
                        continue
                    seen.add(key)
                    dp = bsm.DevicePlan(p, dev)
                    out = bsm.run_plan(x, sw.w_padded, sw.indices, dp, N)
                    torch.cuda.synchronize()
                    err = float((out - want).abs().max())
                    ms = bu.device_ms(lambda: bsm.run_plan(
                        x, sw.w_padded, sw.indices, dp, N), budget_ms=20.0)
                    rows.append({"tile": list(p.tile), "min_chunks": min_chunks,
                                 "target": tgt, "blocks": p.blocks,
                                 "max_splits": p.max_splits, "ms": ms,
                                 "err": err,
                                 "default": key == (default.tile,
                                                    default.items.tobytes())})
        lib = bu.device_ms(lambda: torch.matmul(x, wm), budget_ms=20.0)
        bound, by = bu.matmul_bound_ms(sw, M, 4)
        best = min(rows, key=lambda r: r["ms"])
        dflt = [r for r in rows if r["default"]]
        print(json.dumps({"M": M, "K": K, "N": N, "steps": sw.steps,
                          "dense_steps": sw.dense_steps, "library_ms": lib,
                          "bound_ms": bound, "best": best,
                          "default": dflt[0] if dflt else None,
                          "plans": rows}), flush=True)


def time_clip() -> None:
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    tot, tot_b = 0.0, 0.0
    for name, shape in bu.main_path_clip_shapes():
        x = torch.relu(torch.randn(shape, generator=gen)).to("cuda")
        ms = bu.device_ms(lambda: kops.act_clip(x, 0.3))
        bound, _ = bu.clip_bound_ms(x, 1)
        tot += ms
        tot_b += bound
        print(json.dumps({"clip": name, "shape": list(shape), "ms": ms,
                          "bound_ms": bound}), flush=True)
    print(json.dumps({"clip_total_ms": tot, "clip_bound_ms": tot_b}))


def main() -> None:
    if not torch.cuda.is_available():
        print("kernel_sweep_torch: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.lib()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "build_s": build.build_seconds,
                      "ptxas": ptxas_report()}), flush=True)
    time_clip()
    sweep_matmul("--quick" in sys.argv)


if __name__ == "__main__":
    main()
