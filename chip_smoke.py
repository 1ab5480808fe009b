"""Quickest proof that the PyTorch/CUDA port starts and is right on an NVIDIA
GPU: one HASS search on ResNet-18 at its full published widths, driven through
the entry points a user calls, with both hand-written CUDA kernels built from
their sources and held against their plain PyTorch versions.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Phases (each prints one JSON line; any failure exits non-zero):

  device   card name and power limit, torch / CUDA versions, kernel build time
  kernels  each kernel against its plain version on the card: the reference
           tests' shapes and dtypes, then the search's own shapes with kernel,
           plain, bound and one-PyTorch-call times
  search   SGD warm-up, CNNEvaluator, hass_search hardware-aware and
           software-only (16 trials each, 8 per round), a short serial run and
           its batch_size=1 replay; counts act_clip_count launches
  execute  the winner's pruned weights through block_sparse_matmul
  timing   the execute step's products again, timed: kernel, plain, bound,
           dense library call

Times: ``ms`` is the kernel alone on the device (``act_clip_count`` /
``block_sparse_matmul`` called on operands already padded, inside a CUDA graph
that is then replayed, so the host's cost of making a call is not in the
number: the main path pays that cost too, see ``wrapper_ms``), ``library_ms``
one dense ``x @ w`` timed the same way, ``plain_device_ms`` the clip's plain
version timed the same way, ``wrapper_ms`` the whole any-shape wrapper call as
the main path makes it (padding, allocation, the launch, the sum of the
counts; host cost included) and ``plain_ms`` the plain PyTorch version called
the same way. ``bound_ms`` counts the unpadded operands of the function the
main path calls: padding to tiles is the kernel's cost, not the work's.

The launch counters are set to 0 just before ``search`` and read just after
``execute``. The card's name and power limit and then one line listing every
kernel come before the last line, which is the device record. There is no CPU
path: without a card the script exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # float32 outside the tensor cores
BF16_FLOPS = 989e12              # dense bf16 tensor-core rate

RESNET18_IMG_RES = 224
CALIB_BATCH = 8
MAX_M = 25088


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, *, warmup: int = 3, min_reps: int = 5, budget_ms: float = 60.0
            ) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events around a run of
    launches (inputs stay where the previous launch left them: warm L2, as
    the caller that has just produced an activation finds it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    reps = int(max(min_reps, min(200, budget_ms / one)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, *, budget_ms: float = 40.0) -> float:
    """Device time of one ``fn()``: a run of calls captured in one CUDA graph
    and replayed, CUDA events around the replays. ``fn`` must allocate
    nothing it keeps and must not synchronise (a kernel's wrapper on padded
    operands; one ``torch.matmul``). Warm L2, as in ``time_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    per_graph = int(max(4, min(50, budget_ms / 4 / one)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = 4
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * per_graph)


# ------------------------------------------------------------------------- #
# bounds: the least time the card could take for the same work
# ------------------------------------------------------------------------- #
def clip_bound_ms(x: torch.Tensor, n_tiles: int):
    """Read x once, write y once, one int32 per tile; one compare per
    element on the float32 pipes."""
    by = 2 * x.numel() * x.element_size() + 4 * n_tiles
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    t_ops = x.numel() / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def matmul_bound_ms(sw, M: int, elem_size: int):
    """The least work of ``x (M, K) @ w (K, N)`` under ``sw``'s schedule, on
    the unpadded operands: 2 * M * rows * cols flops for every scheduled tile
    (its real rows and columns inside (K, N)), against x's columns that any
    scheduled tile names read once, the scheduled part of w once, the float32
    output once, and the schedule's used entries."""
    counts = sw.counts.cpu().numpy()
    idx = sw.indices.cpu().numpy()
    K, N = sw.shape
    bk, bn = sw.bk, sw.bn
    w_elems, used_kt = 0, set()
    for j, c in enumerate(counts):
        cols = min(bn, N - j * bn)
        for kt in idx[j, :c].tolist():
            w_elems += min(bk, K - kt * bk) * cols
            used_kt.add(kt)
    x_cols = sum(min(bk, K - kt * bk) for kt in used_kt)
    steps = int(counts.sum())
    flops = 2.0 * M * w_elems
    by = (M * x_cols * elem_size + w_elems * elem_size + M * N * 4
          + 4 * len(counts) + 4 * steps)
    t_ops = flops / (FP32_FLOPS if elem_size == 4 else BF16_FLOPS) * 1e3
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


# ------------------------------------------------------------------------- #
# phases
# ------------------------------------------------------------------------- #
def phase_device():
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi gave nothing: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    t0 = time.perf_counter()
    build.lib()                      # raises when nvcc or a source fails
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kernel_build_s=round(build.build_seconds, 3),
         kernel_load_s=round(time.perf_counter() - t0, 3),
         nvcc=build.find_nvcc(), flags=" ".join(build.NVCC_FLAGS))
    return card


def main_path_clip_shapes():
    """The 21 inputs of ResNet-18's prunable layers for 8 images of 224 x 224:
    what one stats forward hands to ``ops.act_clip``."""
    from repro_torch.configs.paper_cnns import RESNET18
    from repro_torch.models import cnn
    shapes = []
    for s in cnn.build_specs(RESNET18):
        if s.prunable:
            shapes.append((s.name, (CALIB_BATCH, s.in_hw, s.in_hw, s.cin)
                           if s.kind == "conv" else (CALIB_BATCH, s.cin)))
    return shapes


def phase_kernels_clip(dev):
    from repro_torch.kernels import act_clip, ops, ref
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    max_err, cases = 0.0, 0
    # the reference tests' shapes, dtypes and taus (+ one tau that is not
    # bf16-exact), with zeros and negative zeros planted
    for shape in [(64, 64), (100, 333), (7, 1024), (1, 9)]:
        for dtype in (torch.float32, torch.bfloat16):
            for tau in (0.0, 0.2995, 0.5, 2.0):
                x = torch.randn(shape, generator=gen).to(dtype)
                x.view(-1)[::7] = 0.0
                x.view(-1)[3::11] = -0.0
                x = x.to(dev)
                y, cnt = ops.act_clip(x, tau)
                y_ref, cnt_ref = ref.act_clip_count_ref(x, tau)
                torch.cuda.synchronize()
                if not torch.equal(_bits(y), _bits(y_ref)) or \
                        int(cnt) != int(cnt_ref):
                    fail(f"act_clip_count != plain at {shape} {dtype} "
                         f"tau={tau}: count {int(cnt)} vs {int(cnt_ref)}")
                max_err = max(max_err, float(
                    (y.float() - y_ref.float()).abs().max()))
                cases += 1
    rows, tot = [], {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                     "plain_device_ms": 0.0, "bound_ms": 0.0}
    tau = 0.3
    tau_dev = torch.tensor(tau, dtype=torch.float32, device=dev)
    for name, shape in main_path_clip_shapes():
        # a post-ReLU-like activation: about half zeros already
        x = torch.relu(torch.randn(shape, generator=gen)).to(dev)
        y, cnt = ops.act_clip(x, tau)
        y_ref, cnt_ref = ref.act_clip_count_ref(x, tau)
        if not torch.equal(_bits(y), _bits(y_ref)) or int(cnt) != int(cnt_ref):
            fail(f"act_clip_count != plain at main-path input {name}")
        cases += 1
        # the kernel alone, on the 2-D operand ops.act_clip hands it (every
        # one of these inputs is a whole number of 256-wide rows)
        x2 = x.reshape(-1, 256)
        bm = min(256, x2.shape[0])
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, (-x2.shape[0]) % bm))
        blocks = x2.shape[0] // bm
        bound, by = clip_bound_ms(x, blocks)
        ms = device_ms(lambda: act_clip.act_clip_count(x2, tau, bm=bm,
                                                       bn=256))
        wrapper = time_ms(lambda: ops.act_clip(x, tau))
        plain = time_ms(lambda: ref.act_clip_count_ref(x, tau))
        # the plain version's device time (tau already on the card, so that
        # the graph holds no copy from the host)
        plain_dev = device_ms(lambda: ref.act_clip_count_ref(x, tau_dev))
        rows.append({"layer": name, "shape": list(shape), "blocks": blocks,
                     "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
                     "plain_device_ms": plain_dev,
                     "bound_ms": bound, "bound_by": by})
        tot["wrapper_ms"] += wrapper
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["plain_device_ms"] += plain_dev
        tot["bound_ms"] += bound
    return {"name": "act_clip_count", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/act_clip_count.cu",
            "replaces": "src/repro/kernels/act_clip.py:40",
            "equal": True, "cases": cases, "max_abs_err": max_err,
            "tolerance": "bit-equal output and equal count",
            "ms": tot["ms"], "wrapper_ms": tot["wrapper_ms"],
            "plain_ms": tot["plain_ms"],
            "plain_device_ms": tot["plain_device_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            # no single PyTorch call clips and counts: the plain version
            # (torch.where, then == 0 and sum) is the only yardstick, and
            # plain_device_ms is its time on the device
            "library_ms": None,
            "timed_over": "the 21 inputs of one stats forward, f32, summed",
            "shapes": rows}


def _tile_sparse(K, N, density, gen, lecun=True):
    """A (K, N) weight with about ``density`` of its 128 x 128 tiles kept;
    ``lecun`` scales it 1/sqrt(K) as an initialised layer has it, so that
    outputs stay O(1) at the search's large K."""
    w = torch.randn((K, N), generator=gen)
    if lecun:
        w = w / np.sqrt(K)
    Kt, Nt = -(-K // 128), -(-N // 128)
    keep = torch.rand((Kt, Nt), generator=gen) < density
    if density >= 1.0:
        keep[:] = True
    m = keep.repeat_interleave(128, 0).repeat_interleave(128, 1)[:K, :N]
    return w * m


def kernel_alone_ms(sw, x, budget_ms: float = 60.0) -> float:
    """block_sparse_matmul's kernel alone: called on the padded operands
    ``SparseWeight.matmul`` hands it."""
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels.ops import _pad_to
    xp = _pad_to(x, 128, sw.bk).contiguous()
    return device_ms(lambda: bsm.block_sparse_matmul(
        xp, sw.w_padded, sw.counts, sw.indices, bk=sw.bk, bn=sw.bn),
        budget_ms=budget_ms)


def phase_kernels_matmul(dev):
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cpu")
    gen.manual_seed(11)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    test_shapes = [(128, 128, 128), (256, 384, 256), (100, 300, 200),
                   (64, 512, 128)]
    main_shapes = [(MAX_M, 147, 64), (MAX_M, 576, 64), (6272, 576, 128),
                   (6272, 1152, 128), (6272, 64, 128), (1568, 1152, 256),
                   (1568, 2304, 256), (1568, 128, 256), (392, 2304, 512),
                   (392, 4608, 512), (392, 256, 512), (8, 512, 1000)]
    for (M, K, N) in test_shapes + main_shapes:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-1)):
            x = torch.randn((M, K), generator=gen).to(dtype).to(dev)
            # unit-normal weights at the reference tests' shapes, as there
            w = _tile_sparse(K, N, 0.6, gen,
                             lecun=(M, K, N) not in test_shapes)
            w = w.to(dtype).to(dev)
            sw = ops.SparseWeight(w)
            out = sw.matmul(x)
            want = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if not torch.allclose(out, want, atol=tol, rtol=tol):
                fail(f"block_sparse_matmul != plain at {(M, K, N)} {dtype}: "
                     f"max |err| {err}")
            key = "float32" if dtype == torch.float32 else "bfloat16"
            max_err[key] = max(max_err[key], err)
            cases += 1
    # a masked tile is never read, even where w is non-zero there
    x = torch.ones((128, 256), device=dev)
    w = torch.ones((256, 128), device=dev)
    counts, indices = bsm.build_tile_schedule(np.array([[True], [False]]))
    out = bsm.block_sparse_matmul(x, w, torch.from_numpy(counts).to(dev),
                                  torch.from_numpy(indices).to(dev))
    if not torch.equal(out, torch.full_like(out, 128.0)):
        fail("block_sparse_matmul read a masked tile")
    out = bsm.block_sparse_matmul(
        x, w, torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.from_numpy(indices).to(dev))
    if float(out.abs().max()) != 0.0:
        fail("block_sparse_matmul: an empty column is not zero")
    cases += 2
    # tile densities 1.0 / 0.75 / 0.5 / 0.25 at one of the search's shapes,
    # beside the dense library product x @ (w * mask)
    sweep = []
    M, K, N = 6272, 2304, 256
    x = torch.randn((M, K), generator=gen).to(dev)
    for density in (1.0, 0.75, 0.5, 0.25):
        w = _tile_sparse(K, N, density, gen).to(dev)
        sw = ops.SparseWeight(w)
        wm = sw.w_padded[:K, :N].contiguous()
        out = sw.matmul(x)
        if not torch.allclose(out, x @ wm, atol=1e-4, rtol=1e-4):
            fail(f"block_sparse_matmul != x @ w at density {density}")
        bound, by = matmul_bound_ms(sw, M, 4)
        sweep.append({
            "M": M, "K": K, "N": N, "target_density": density,
            "tile_density": sw.tile_density, "steps": sw.steps,
            "dense_steps": sw.dense_steps,
            "ms": kernel_alone_ms(sw, x),
            "wrapper_ms": time_ms(lambda: sw.matmul(x)),
            "plain_ms": time_ms(lambda: ref.block_sparse_matmul_ref(
                x, w, sw.mask, 128, 128)),
            "library_ms": device_ms(lambda: torch.matmul(x, wm)),
            "bound_ms": bound, "bound_by": by})
    return {"name": "block_sparse_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
            "replaces": "src/repro/kernels/block_sparse_matmul.py:146",
            "cases": cases, "max_abs_err_f32": max_err["float32"],
            "max_abs_err_bf16": max_err["bfloat16"],
            "tolerance": "allclose atol=rtol=1e-4 (f32) / 2e-1 (bf16 inputs)",
            "density_sweep": sweep}


def transcript(res):
    return [(t.x.tolist(), t.score) for t in res.trials]


def phase_search(dev):
    from repro_torch.core.hass import hass_search
    from repro_torch.kernels import launch_counts
    from repro_torch.search_run import search_compare
    payload = search_compare(iters=16, img_res=RESNET18_IMG_RES, seed=0,
                             budget=12234, batch_size=8, device=dev,
                             train_steps=20)
    ev = payload["ev"]
    L = len(ev.prunable)
    if L != 21:
        fail(f"ResNet-18 should have 21 prunable layers, found {L}")
    # a short serial run, and its replay through the batched loop at size 1
    t0 = time.perf_counter()
    serial = hass_search(ev, L, iters=4, seed=1, batch_size=None)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    replay = hass_search(ev, L, iters=4, seed=1, batch_size=1)
    if transcript(serial) != transcript(replay):
        fail("batch_size=1 did not replay the serial transcript")
    # the dense proposal must agree with the dense reference exactly
    dense = ev(np.zeros(2 * L))
    if dense["acc"] != 1.0:
        fail(f"the unpruned proposal scored acc {dense['acc']}, not 1.0")
    # 16 + 16 + 4 + 4 trials and the dense proposal: 41 stats forwards, each
    # one act_clip_count launch per prunable layer
    launches = launch_counts()["act_clip_count"]
    if launches != 21 * ev.stats_forwards or ev.stats_forwards != 41:
        fail(f"act_clip_count launches {launches} != 21 x "
             f"{ev.stats_forwards} stats forwards (41 expected)")
    for res in (payload["hw_result"], payload["sw_result"], serial):
        for t in res.trials:
            m = t.metrics
            if not (np.isfinite(t.score) and 0.0 <= m["acc"] <= 1.0
                    and 0.0 <= m["spa"] <= 1.0 and m["thr"] > 0
                    and 0.0 < m["dsp"] <= 1.0 + 1e-9 and len(t.x) == 2 * L):
                fail(f"a trial's metrics are out of range: {m}")
    emit("search", model="resnet18", img_res=RESNET18_IMG_RES,
         calib_images=CALIB_BATCH, prunable_layers=L, iters=16, batch_size=8,
         dse_backend=payload["dse_backend"],
         setup_s=payload["setup_s"], search_s=payload["search_s"],
         trials_per_s=payload["trials_per_s"],
         serial_trials_per_s=4 / serial_s,
         stats_forwards=ev.stats_forwards,
         act_clip_launches_per_forward=21,
         act_clip_launches=launches,
         batch1_replays_serial=True,
         hw_best={k: payload["hw_best"][k] for k in
                  ("acc", "spa", "thr", "dsp", "eff", "score")},
         sw_best={k: payload["sw_best"][k] for k in
                  ("acc", "spa", "thr", "dsp", "eff", "score")})
    return payload


def phase_execute(payload):
    from repro_torch.search_run import execute_winner
    ev = payload["ev"]
    rows = execute_winner(ev, payload["hw_result"].best_x, max_m=MAX_M,
                          keep_operands=True)
    torch.cuda.synchronize()
    bad = [r["layer"] for r in rows if not r["ok"]]
    if bad or len(rows) != 22:
        fail(f"execute: {len(rows)} products, disagreeing with plain: {bad}")
    emit("execute", products=len(rows),
         schedule_steps=sum(r["schedule_steps"] for r in rows),
         dense_steps=sum(r["dense_steps"] for r in rows),
         max_abs_err=max(r["max_abs_err"] for r in rows),
         layers=[{k: v for k, v in r.items() if k != "operands"}
                 for r in rows])
    return rows


def phase_timing(rows):
    """The execute step's products again, on the same operands, timed."""
    from repro_torch.kernels import ref
    out, tot = [], {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                    "library_ms": 0.0,
                    "bound_ms": 0.0, "ops_bound_ms": 0.0}
    for r in rows:
        sw, x, wp = r["operands"]
        bound, by = matmul_bound_ms(sw, x.shape[0], x.element_size())
        ms = kernel_alone_ms(sw, x, budget_ms=30.0)
        wrapper = time_ms(lambda: sw.matmul(x), budget_ms=30.0)
        plain = time_ms(lambda: ref.block_sparse_matmul_ref(
            x, wp, sw.mask, sw.bk, sw.bn), budget_ms=30.0)
        lib = device_ms(lambda: torch.matmul(x, wp), budget_ms=30.0)
        out.append({"layer": r["layer"], "x": r["x"], "M": r["M"],
                    "K": r["K"], "N": r["N"], "steps": r["schedule_steps"],
                    "dense_steps": r["dense_steps"], "ms": ms,
                    "wrapper_ms": wrapper, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": bound,
                    "bound_by": by})
        tot["ms"] += ms
        tot["wrapper_ms"] += wrapper
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bound_ms"] += bound
        tot["ops_bound_ms"] += bound if by == "operations" else 0.0
    by = "operations" if tot["ops_bound_ms"] >= 0.5 * tot["bound_ms"] \
        else "bytes"
    return out, tot, by


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures on the card "
              "and has no CPU path", file=sys.stderr)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails here when the package is absent)
    from repro_torch import kernels
    from repro_torch.search_run import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = phase_device()
    clip = phase_kernels_clip(dev)
    mm = phase_kernels_matmul(dev)
    emit("kernels", kernels=[clip, mm])

    # the main path: every launch counter to 0 just before, read just after
    kernels.reset_launch_counts()
    payload = phase_search(dev)
    rows = phase_execute(payload)
    counts = kernels.launch_counts()
    if counts["act_clip_count"] < 21 or counts["block_sparse_matmul"] != 22:
        fail(f"the main path did not go through the kernels: {counts}")

    timing_rows, tot, by = phase_timing(rows)
    emit("timing", card=card, products=timing_rows, totals=tot)

    record = {"kernels": [
        {"name": clip["name"], "route": clip["route"],
         "source": clip["source"], "replaces": clip["replaces"],
         "launches": counts["act_clip_count"],
         "max_abs_err": clip["max_abs_err"], "ms": clip["ms"],
         "wrapper_ms": clip["wrapper_ms"], "plain_ms": clip["plain_ms"],
         "plain_device_ms": clip["plain_device_ms"],
         "bound_ms": clip["bound_ms"],
         "bound_by": clip["bound_by"], "library_ms": clip["library_ms"]},
        {"name": mm["name"], "route": mm["route"], "source": mm["source"],
         "replaces": mm["replaces"],
         "launches": counts["block_sparse_matmul"],
         "max_abs_err": max(mm["max_abs_err_f32"],
                            max(r["max_abs_err"] for r in rows)),
         "ms": tot["ms"], "wrapper_ms": tot["wrapper_ms"],
         "plain_ms": tot["plain_ms"],
         "bound_ms": tot["bound_ms"], "bound_by": by,
         "library_ms": tot["library_ms"]},
    ]}
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
