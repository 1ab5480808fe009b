"""Quickest proof that the PyTorch/CUDA port starts and is right on an NVIDIA
GPU: one HASS search on ResNet-18 at its full published widths, driven through
the entry points a user calls, then Table II's search on all five paper CNNs,
with the hand-written CUDA kernels built from their sources and held against
their plain PyTorch versions.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --costs-out experiments/kernel_costs_h100.json
                                     # also writes the main-path cost table

Phases (each prints one JSON line; any failure exits non-zero):

  device   card name and power limit, torch / CUDA versions, kernel build time
  kernels  each kernel against its plain version on the card: the reference
           tests' shapes and dtypes, then the search's own shapes with kernel,
           plain, bound and one-PyTorch-call times; the clip's batched entry
           (gate b) at the 21 ResNet-18 clip inputs of a round of 8
           proposals and of a serial pass (1 proposal), one tau each: y bit
           for bit, counts equal; the implicit-GEMM convolution
           (conv_igemm) at each distinct shape of the 20 ResNet-18 layers it
           takes in a batched pass of 8 proposals, TF32 off: y bit for bit
           against its plain version (cuDNN's grouped convolution), bias
           and activation included, and a second launch equal to the
           first, each shape timed beside its plain version, the library
           and the bound; the same at ConvNeXt-T's four routed shapes (the
           unpadded 4 x 4 stride-4 stem, the 2 x 2 stride-2 downsampling
           layers), summed as a second group
  kernel_costs  the pattern decode-cost tables (``kernels.kernel_costs``)
           measured on the card at the default probe shape and at the main
           path's (a ResNet-18 layer-3 im2col product): each probe's time,
           mode and check against its plain version, the decode factors and
           the block_sparse_matmul launches
  search   SGD warm-up (one step captured as a CUDA graph and replayed;
           warmup_s), CNNEvaluator, hass_search hardware-aware and
           software-only (16 trials each, 8 per round: one batched program,
           captured once as a CUDA graph and replayed), a short serial run
           and its batch_size=1 replay (gate e); gates: launches of the
           clip's batched entry == prunable layers x stats passes and of its
           single entry 0, of conv_igemm == its 20 layers x the 4 batched
           passes (none in a serial pass), stats forwards == the proposals
           evaluated, the 16-trial searches built one shape (gate c); prints graphs
           captured, capture seconds, graph-pool bytes, trials/s batched
           and serial
  search_gates  right after the main path's counts are read, on its
           evaluator: (a) one captured replay == the same batched pass run
           eagerly, bit for bit; (c) a ragged 3 + 3 + 2 search pads its tail
           and builds one new shape; (d) every batched trial of both
           searches within rel 1e-3 / abs 1e-6 of the same proposal through
           the serial path; launches == prunable layers x passes, and
           conv_igemm's == 20 x the batched ones
  execute  the winner's pruned weights through block_sparse_matmul
  patterns the search's configuration again with the pattern axis: the
           degenerate ("unstructured",) axis replays the search's transcript
           (gate e), then all four patterns priced by the main-path table
           (the pattern program: every branch per layer, selected by code)
  timing   the execute step's products again, timed: kernel, plain, bound,
           dense library call, and each product's work plan (tile, splits,
           blocks)
  profile  the device's busy share over one batched round of the search
           (8 proposals), from a torch.profiler trace, or "not measured";
           and the device operations of one main-path call of each wrapper
  paper    Table II on the card: benchmarks_torch.table2_models.row for all
           five paper CNNs (ResNet-18/50, MobileNetV2, MobileNetV3-S/L) at
           their published widths and 224 x 224, 8 calibration images, each
           model's Table II budget, 8 hardware-aware TPE trials; each winner
           through execute_winner (every product within 1e-4 of its plain
           version); gates: launches of the clip's batched entry ==
           prunable layers x stats passes (its single entry 0) and
           block_sparse_matmul launches == products per model, the dense
           proposal scores acc 1.0, metrics in range; per model the
           products' summed kernel / library / bound times and one serial
           stats pass's clip inputs through the batched entry, checked
           against its plain version and timed; before each model its
           captured SGD warm-up == the same warm-up run eagerly and
           captured again, bit for bit (warmup_s, eager_warmup_s,
           captured_warmup_again_s)
  serve    Qwen3-0.6B at full width through ServeSession: 16 requests of 128
           prompt tokens, 8 slots, bf16; the session decodes through one
           CUDA graph per cache shape, captured once and replayed per
           token; four gates (teacher forcing, open loop == generate,
           determinism, ragged rows) and gate (a): 8 replayed steps == the
           eager api.decode_step from the same prefill, logits and every
           cache leaf bit for bit (else within 1e-3 x max |logits|, said
           so); prefill, eager and replayed step times, tokens/s, captures,
           capture seconds, graph-pool bytes, device operations and busy
           share over 8 eager and 8 replayed steps
  fleet    the serve phase's session again, open loop: the busiest replica's
           stream of an autoscale policy search, and a degraded step schedule
           with deadlines, each against fleet.open_loop_schedule's clocks
  serve_families  every LM family at reduce_config size on the card (Qwen3,
           Mixtral with its 8-slot sliding-window ring, DeepSeek-V3's MLA +
           MoE, Zamba2, RWKV6, Whisper): a buffer set captured from a
           6-token prefill, then 8 replayed decode steps bit-equal to the
           eager step, every cache leaf too
  bench_twins  six benchmark twins of benchmarks_torch/, each
           run(smoke=True) on the card called directly (obs in the
           reference's full mode, its overhead gate the least of 5 paired
           ratios, in a process of its own): roofline (over one
           dry-run cell cut to 2 layers, run in its own process: its
           collective term and collectives by op must be there), lm_dse,
           sim, fleet,
           chaos, obs, with all of their own gates (the 1M-event engine race >= 10x, the LM DSE >=
           10x, tracer overhead < 3 %); fleet's replay and chaos's
           zero_fault and replay serve Qwen3-0.6B at full width in bf16 and
           must equal the same sections run on the CPU at reduce_config
           size; no job launches an SPE kernel; then
           examples/quickstart_torch.py on the card: launches of the clip's
           batched entry == prunable layers x stats passes, of its single
           entry 1, block_sparse_matmul >= 1, its product within 1e-4 of the
           plain version; decode ms per step of the replays
  deploy   host only: search -> partition -> simulate -> SLO pick on
           Qwen3-0.6B over 4 modeled chips (repro_torch.deploy_run)
  train    Qwen3-0.6B at full width trained 8 AdamW steps through
           TrainProgram(make_train_step) fed by DataPipeline (bf16 compute,
           float32 masters, accum 2, remat "full"; the first step captures
           the step as a CUDA graph, the rest replay it), then 8 eager and 8
           replayed steps in turns: replayed and eager step times,
           tokens/s, captures, capture seconds, graph-pool bytes, peak
           memory, busy share and device operations of a replayed and of an
           eager step, the step's bound; gates: the loss falls, one capture
           and one buffer set, card == CPU (float32, depth 2), accum 2 == 1
           and remat none == full == dots (eager), no SPE kernel launched;
           the replay == eager gate runs in ``deterministic``
  train_families  every LM family at reduce_config size (the
           serve_families six), the train recipe on batches of 4 x 32: 1
           capturing and 8 replayed steps of a TrainProgram against 9 plain
           steps from a copy of the state, every loss and the final state
           bit for bit, one capture each; replayed and eager ms per step (run
           in the deterministic subprocess, printed as its own line)
  distributed  an NCCL process group of one rank (a FileStore in a temp
           directory) and a (1, 1) ("data", "model") DeviceMesh: gates
           compressed_psum == ef_quantize and a one-stage 8-microbatch
           make_pipelined_fn == the sequential loop, bit for bit; then the
           train phase's Qwen3-0.6B step with its state laid out as DTensors
           by param_specs under use_sharding (1 warm-up and 4 timed steps, one
           profiled), beside the train phase's numbers; one more step
           under op_costs.OpCounter on the card's tensors, whose counted
           flops must equal the same step's count on meta tensors (a
           subprocess, fake backend); one dry-run cell (qwen3-0.6b
           train_4k pod2x16x16 at full depth, fake backend, its own
           process): its sharded step run and counted (bytes per rank,
           flops, collectives by op, temp bytes, run_s); no SPE kernel
           launched
  deterministic  a process of its own, with CUBLAS_WORKSPACE_CONFIG=:4096:8
           and torch.use_deterministic_algorithms: the restart gate (int8
           state, each run through its own TrainProgram; a crash and a
           restore copied into the captured state give the same losses and
           state bit for bit), sharded == unsharded training (2 eager steps
           of the train phase's full-depth step from one initial state:
           losses and the final state bit for bit), the train phase's step
           replayed == eager (1 capturing and 8 replayed steps from one
           state at full width: every loss, parameter, moment and the step
           bit for bit) and
           train_families; no other phase runs under that setting

Times: ``ms`` is the device time of the call the main path makes
(``ops.act_clip`` / ``ops.act_clip_batched`` / ``SparseWeight.matmul`` on the
operands the main path hands them, unpadded, inside a CUDA graph that is then
replayed, so the host's cost of making a call is not in the number: the main
path pays that cost too, see ``wrapper_ms``); it holds every device operation
of the call (the matmul's split reduction too). ``library_ms`` is one dense
``x @ w`` timed the same way (for conv_igemm one grouped cuDNN convolution
on its own weight layout, without bias or activation), ``plain_device_ms`` the clip's plain version
timed the same way, ``wrapper_ms`` the same call eagerly with its host cost,
and ``plain_ms`` the plain PyTorch version called the same way. ``bound_ms``
counts the unpadded operands of the function the main path calls: padding to
tiles is the kernel's cost, not the work's.

A batched stats pass replays a CUDA graph: the launches the graph holds
count at each replay, never at its capture (``kernels.graph``). The launch
counters are set to 0 just before ``search`` and read just after
``execute``, and again around ``search_gates``, each of ``kernel_costs``' two tables,
``patterns``, each model of ``paper``, ``serve`` with ``fleet``,
``serve_families``, each job
of ``bench_twins`` and its quickstart, ``train``, ``train_families`` and
``distributed``. The
card's name and power limit and then one line listing every kernel (the
clip's single and batched entries apart), with its launches on each path,
come before the last line, which is the device record. The single entry's
``launches`` are those of the path that runs it, the quickstart. Each phase's seconds are
in the ``done`` line. There is no CPU path: without a card the script exits
2.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
RESNET18_IMG_RES = 224
CALIB_BATCH = 8
MAX_M = 25088


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def phase_kernels_clip(dev):
    from repro_torch.kernels import act_clip, ops, ref
    from repro_torch.kernels.bench_util import (clip_bound_ms, device_ms,
                                                main_path_clip_shapes, time_ms)
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
    # the kernel's own outputs on ragged inputs: per-tile counts with the
    # tiles' padding as zeros, the total without it
    for shape in [(1, 9), (100, 333), (2, 56, 56, 64), (3, 1000003)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to(dtype).to(dev)
            y, cnt, total = act_clip.act_clip_count_flat(x, 0.3)
            y_ref, cnt_ref, total_ref = act_clip.act_clip_count_flat(
                x.cpu(), 0.3)
            cols, bm, tiles = act_clip.flat_tiles(x.numel())
            padding = tiles * bm * cols - x.numel()
            if not torch.equal(_bits(y.cpu()), _bits(y_ref)) or \
                    not torch.equal(cnt.cpu(), cnt_ref) or \
                    int(total) != int(total_ref) or \
                    int(total) != int(cnt.sum()) - padding:
                fail(f"act_clip_count_flat != plain at {shape} {dtype}")
            cases += 1
    rows, tot = [], {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                     "plain_device_ms": 0.0, "bound_ms": 0.0}
    tau = 0.3
    tau_dev = torch.tensor(tau, dtype=torch.float32, device=dev)
    for name, shape in main_path_clip_shapes(CALIB_BATCH):
        # a post-ReLU-like activation: about half zeros already
        x = torch.relu(torch.randn(shape, generator=gen)).to(dev)
        y, cnt = ops.act_clip(x, tau)
        y_ref, cnt_ref = ref.act_clip_count_ref(x, tau)
        if not torch.equal(_bits(y), _bits(y_ref)) or int(cnt) != int(cnt_ref):
            fail(f"act_clip_count != plain at main-path input {name}")
        cases += 1
        # the call the main path makes, on x as it lies
        tiles = act_clip.flat_tiles(x.numel())[2]
        bound, by = clip_bound_ms(x, tiles)
        ms = device_ms(lambda: ops.act_clip(x, tau))
        wrapper = time_ms(lambda: ops.act_clip(x, tau))
        plain = time_ms(lambda: ref.act_clip_count_ref(x, tau))
        # the plain version's device time (tau already on the card, so that
        # the graph holds no copy from the host)
        plain_dev = device_ms(lambda: ref.act_clip_count_ref(x, tau_dev))
        rows.append({"layer": name, "shape": list(shape), "tiles": tiles,
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


SEARCH_BATCH = 8          # proposals per round of the search phase


def _clip_batched_at(dev, gen, B: int) -> dict:
    """The clip's batched entry against its plain version at the 21
    ResNet-18 clip inputs of one stats pass of B proposals (8 images at 224
    x 224, the proposals' channels side by side, one tau each): y bit for
    bit, every proposal's count equal. Then each input timed as the
    evaluator calls it (device time in a CUDA graph), beside the plain
    version and the bound 2 x B x n x 4 bytes over the memory rate."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bench_util import (clip_bound_ms, device_ms,
                                                main_path_clip_shapes, time_ms)
    taus = torch.linspace(0.05, 0.6, B, dtype=torch.float32).to(dev)
    rows, tot, max_err = [], dict.fromkeys(
        ("ms", "plain_ms", "plain_device_ms", "bound_ms"), 0.0), 0.0
    for name, shape in main_path_clip_shapes(CALIB_BATCH):
        stacked = shape[:-1] + (B * shape[-1],)
        x = torch.relu(torch.randn(stacked, generator=gen)).to(dev)
        y, cnt = ops.act_clip_batched(x, taus)
        y_ref, cnt_ref = ref.act_clip_count_batched_ref(x, taus)
        if not torch.equal(_bits(y), _bits(y_ref)) or \
                not torch.equal(cnt, cnt_ref):
            fail(f"act_clip_count_batched != plain at {name} {stacked}: "
                 f"{cnt.tolist()} vs {cnt_ref.tolist()}")
        max_err = max(max_err, float((y - y_ref).abs().max()))
        bound, by = clip_bound_ms(x, B)
        t = {"ms": device_ms(lambda: ops.act_clip_batched(x, taus)),
             "plain_ms": time_ms(
                 lambda: ref.act_clip_count_batched_ref(x, taus)),
             "plain_device_ms": device_ms(
                 lambda: ref.act_clip_count_batched_ref(x, taus)),
             "bound_ms": bound}
        rows.append({"layer": name, "shape": list(stacked), **t,
                     "bound_by": by})
        for k, v in t.items():
            tot[k] += v
    return {"cases": len(rows), "max_abs_err": max_err, **tot,
            "proposals": B, "shapes": rows}


def phase_kernels_clip_batched(dev):
    """Gate (b) at B = 8 (a search round) and B = 1 (a serial pass, where
    the entry cuts the rows into other blocks): the batched entry against
    its plain version, then timed. The record's numbers are the B = 8
    pass's."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(8)
    at8 = _clip_batched_at(dev, gen, SEARCH_BATCH)
    at1 = _clip_batched_at(dev, gen, 1)
    return {"name": "act_clip_count_batched", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/act_clip_count.cu",
            "replaces": "src/repro/kernels/act_clip.py:40",
            "equal": True, "cases": at8["cases"] + at1["cases"],
            "max_abs_err": max(at8["max_abs_err"], at1["max_abs_err"]),
            "tolerance": "bit-equal output and equal count per proposal",
            **{k: at8[k] for k in ("ms", "plain_ms", "plain_device_ms",
                                   "bound_ms", "proposals", "shapes")},
            "bound_by": "bytes", "library_ms": None,
            "timed_over": "the 21 inputs of one batched stats pass of 8 "
                          "proposals, f32, summed",
            "serial": {k: v for k, v in at1.items() if k != "cases"}}


#: the layers of ResNet-18's batched pass that the implicit-GEMM kernel takes
#: (``cnn.is_igemm``: 16 3 x 3s, 3 strided 1 x 1 projections, the stem)
IGEMM_LAYERS = 20
#: the same of ConvNeXt-T's: the unpadded 4 x 4 stride-4 stem and the three
#: 2 x 2 stride-2 downsampling layers
CONVNEXT_IGEMM_LAYERS = 4


def phase_kernels_conv_igemm(dev):
    """The implicit-GEMM kernel at the layers it takes in a batched pass of
    ResNet-18 (the search phase's model) and of ConvNeXt-T, at 224 x 224,
    8 proposals of 8 images, float32 with TF32 off as the evaluator sets
    it, one case per distinct shape and padding: against its plain version
    (the HWIO copy and grouped cuDNN convolution the pass ran before the
    kernel, with the layer's bias and activation) bit for bit, a second
    launch equal to the first. Then each shape timed as the pass calls it
    (device time in a CUDA graph), beside the plain version, the library
    (one grouped cuDNN convolution on its own weight layout, without bias
    or activation) and the bound, each summed over the model's layers of
    that shape: ResNet-18's at the top level, ConvNeXt-T's under
    ``convnext_t``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.hass import _float32_convolutions
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bench_util import (conv_bound_ms, device_ms,
                                                time_ms)
    from repro_torch.models import cnn
    B, models = SEARCH_BATCH, {}
    for arch, want in (("resnet18", IGEMM_LAYERS),
                       ("convnext_t", CONVNEXT_IGEMM_LAYERS)):
        seen = {}
        for s in cnn.build_specs(get_config(arch)):
            if cnn.is_igemm(s, B):
                key = (s.cin, s.cout, s.k, s.stride, s.padding, s.in_hw,
                       s.act == "relu")
                seen[key] = seen.get(key, 0) + 1
        if sum(seen.values()) != want:
            fail(f"{arch}'s routed layers: {seen}")
        models[arch] = seen
    gen = torch.Generator(device="cpu")
    gen.manual_seed(9)
    timed, max_err = {}, 0.0
    with torch.no_grad(), _float32_convolutions():
        for arch, seen in models.items():
            rows, tot = [], dict.fromkeys(
                ("ms", "wrapper_ms", "plain_ms", "plain_device_ms",
                 "library_ms", "bound_ms"), 0.0)
            for (cin, cout, k, stride, pad, hw, relu), n in seen.items():
                x = torch.randn((CALIB_BATCH, hw, hw, B * cin),
                                generator=gen).to(dev)
                w = (torch.randn((B, k, k, cin, cout), generator=gen)
                     / (k * cin ** 0.5)).to(dev)
                b = (torch.randn((cout,), generator=gen) / 4).to(dev)
                y = ops.conv_igemm(x, w, b, stride, relu, pad)
                y_ref = ref.conv_igemm_ref(x, w, b, stride, relu, pad)
                again = ops.conv_igemm(x, w, b, stride, relu, pad)
                torch.cuda.synchronize()
                if not torch.equal(y, y_ref) or not torch.equal(y, again):
                    fail(f"conv_igemm != plain at {arch}'s {cin}x{cout} k{k} "
                         f"s{stride} pad {pad} @{hw}: gap "
                         f"{float((y - y_ref).abs().max())}")
                max_err = max(max_err, float((y - y_ref).abs().max()))
                oihw = w.permute(0, 4, 3, 1, 2).reshape(
                    B * cout, cin, k, k).contiguous()
                nchw = x.permute(0, 3, 1, 2)
                bound, by = conv_bound_ms(x, w, y)
                t = {"ms": device_ms(
                         lambda: ops.conv_igemm(x, w, b, stride, relu, pad)),
                     "wrapper_ms": time_ms(
                         lambda: ops.conv_igemm(x, w, b, stride, relu, pad)),
                     "plain_ms": time_ms(
                         lambda: ref.conv_igemm_ref(x, w, b, stride, relu,
                                                    pad)),
                     "plain_device_ms": device_ms(
                         lambda: ref.conv_igemm_ref(x, w, b, stride, relu,
                                                    pad)),
                     "library_ms": device_ms(lambda: F.conv2d(
                         nchw, oihw, None, stride=stride, padding=pad,
                         groups=B)),
                     "bound_ms": bound}
                rows.append({"shape": [cin, cout, k, stride, hw], "pad": pad,
                             "relu": relu, "layers": n, "x": list(x.shape),
                             **t, "bound_by": by})
                for key, v in t.items():
                    tot[key] += n * v
                del x, w, y, y_ref, again, oihw, nchw
            timed[arch] = {**tot, "bound_by": "/".join(
                               sorted({r["bound_by"] for r in rows})),
                           "layers": sum(seen.values()),
                           "timed_over": f"the {sum(seen.values())} routed "
                                         f"layers of one batched pass of 8 "
                                         f"proposals of 8 images, f32, "
                                         f"summed",
                           "shapes": rows}
    return {"name": "conv_igemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv_igemm.cu",
            "replaces": None, "equal": True,
            "cases": sum(len(t["shapes"]) for t in timed.values()),
            "max_abs_err": max_err,
            "tolerance": "bit-equal to the plain version (cuDNN's grouped "
                         "convolution, TF32 off), bias and activation "
                         "included",
            **timed["resnet18"], "proposals": B,
            "convnext_t": timed["convnext_t"]}


def matmul_device_ms(sw, x, budget_ms: float = 60.0) -> float:
    """block_sparse_matmul's device time as the main path calls it:
    ``SparseWeight.matmul`` on the unpadded x (one launch, or two with the
    split reduction)."""
    from repro_torch.kernels.bench_util import device_ms
    return device_ms(lambda: sw.matmul(x), budget_ms=budget_ms)


def plan_of(sw, M: int) -> dict:
    p = sw.plan(M).plan
    return {"tile": list(p.tile), "max_splits": p.max_splits,
            "blocks": p.blocks, "target": p.target}


def phase_kernels_matmul(dev):
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bench_util import (device_ms, matmul_bound_ms,
                                                tile_sparse_weight, time_ms)
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
            w = tile_sparse_weight(K, N, 0.6, gen,
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
    # a split-K product gives bit-equal outputs on two calls
    x = torch.randn((392, 4608), generator=gen).to(dev)
    sw = ops.SparseWeight(tile_sparse_weight(4608, 512, 0.8, gen).to(dev))
    if sw.plan(392).plan.max_splits < 2:
        fail("the (392, 4608, 512) plan does not split K")
    a, b = sw.matmul(x), sw.matmul(x)
    if not torch.equal(_bits(a), _bits(b)):
        fail("block_sparse_matmul: two calls of a split-K product differ")
    cases += 1
    # tile densities 1.0 / 0.75 / 0.5 / 0.25 at one of the search's shapes,
    # beside the dense library product x @ (w * mask)
    sweep = []
    M, K, N = 6272, 2304, 256
    x = torch.randn((M, K), generator=gen).to(dev)
    for density in (1.0, 0.75, 0.5, 0.25):
        w = tile_sparse_weight(K, N, density, gen).to(dev)
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
            "ms": matmul_device_ms(sw, x),
            "wrapper_ms": time_ms(lambda: sw.matmul(x)),
            "plain_ms": time_ms(lambda: ref.block_sparse_matmul_ref(
                x, w, sw.mask, 128, 128)),
            "library_ms": device_ms(lambda: torch.matmul(x, wm)),
            "bound_ms": bound, "bound_by": by, "plan": plan_of(sw, M)})
    # the same dense product in bf16 (inputs widened, f32 accumulation)
    xb = x.to(torch.bfloat16)
    w = tile_sparse_weight(K, N, 1.0, gen).to(dev).to(torch.bfloat16)
    sw = ops.SparseWeight(w)
    wm = sw.w_padded[:K, :N].contiguous()
    want = ref.block_sparse_matmul_ref(xb, w, sw.mask, 128, 128)
    if not torch.allclose(sw.matmul(xb), want, atol=2e-1, rtol=2e-1):
        fail("block_sparse_matmul != plain at the bf16 dense product")
    bound, by = matmul_bound_ms(sw, M, 2)
    sweep.append({
        "M": M, "K": K, "N": N, "dtype": "bfloat16", "target_density": 1.0,
        "tile_density": sw.tile_density, "steps": sw.steps,
        "dense_steps": sw.dense_steps, "ms": matmul_device_ms(sw, xb),
        "library_ms": device_ms(lambda: torch.matmul(xb, wm)),
        "bound_ms": bound, "bound_by": by, "plan": plan_of(sw, M)})
    return {"name": "block_sparse_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
            "replaces": "src/repro/kernels/block_sparse_matmul.py:146",
            "cases": cases, "max_abs_err_f32": max_err["float32"],
            "max_abs_err_bf16": max_err["bfloat16"],
            "tolerance": "allclose atol=rtol=1e-4 (f32) / 2e-1 (bf16 inputs)",
            "density_sweep": sweep}


def phase_kernel_costs(dev, costs_out=None) -> dict:
    """Both decode-cost tables measured on the card; every probe's product
    is checked against its plain version inside ``measure`` (1e-4), which
    raises where one disagrees, fails to build or to launch."""
    from repro_torch import kernels
    from repro_torch.kernels import kernel_costs as kc
    name = torch.cuda.get_device_name(dev)
    tables, out = {}, {}
    for tag, cfg in (("default", kc.MicrobenchConfig()),
                     ("main_path", kc.MAIN_PATH_CONFIG)):
        checks: list = []
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        table = kc.measure(cfg, dev, checks=checks)
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()["block_sparse_matmul"]
        modes = {table["dense"]["mode"]} | {
            rec["mode"] for lv in table["patterns"].values()
            for rec in lv.values()}
        if modes != {"cuda", "cuda+cuda"} or table.get("unit") != "ns" or \
                table["device"]["name"] != name:
            fail(f"kernel_costs {tag}: modes {sorted(modes)}, unit "
                 f"{table.get('unit')}, device {table.get('device')}")
        if launches < 1 or not checks:
            fail(f"kernel_costs {tag}: {launches} block_sparse_matmul "
                 f"launches, {len(checks)} checked probes")
        err = {p: max(c["max_abs_err"] for c in checks if c["probe"] == p)
               for p in ("tile", "nm")}
        if max(err.values()) > kc.PROBE_TOL:
            fail(f"kernel_costs {tag}: probe error {err}")
        unst = table["patterns"]["unstructured"]
        tables[tag] = table
        out[tag] = {
            "config": table["config"], "seconds": seconds,
            "block_sparse_matmul_launches": launches,
            "probes_checked": len(checks), "max_abs_err": err,
            "tolerance": kc.PROBE_TOL,
            "dense_matmul_ms": table["dense"]["cycles"] / 1e6,
            "tile_all_ones_ms": next(iter(unst.values()))["dense_ref"] / 1e6,
            "ms": {p: {lv: rec["cycles"] / 1e6 for lv, rec in levels.items()}
                   for p, levels in table["patterns"].items()},
            "s_eff": {p: {lv: rec["s_eff"] for lv, rec in levels.items()}
                      for p, levels in table["patterns"].items()},
            "modes": sorted(modes), "decode_factors": table["decode_factors"]}
    # a kernel that skips its zero tiles gets faster as they grow
    unst = tables["main_path"]["patterns"]["unstructured"]
    if not unst["0.7500"]["cycles"] < unst["0.2500"]["cycles"]:
        fail(f"kernel_costs: the tile probe does not fall with sparsity at "
             f"the main-path shape: {unst}")
    if costs_out:
        with open(costs_out, "w") as f:
            json.dump(tables["main_path"], f, indent=1, sort_keys=True)
            f.write("\n")
    return {"tables": out, "main_path_table": tables["main_path"]}


def transcript(res):
    return [(t.x.tolist(), t.score) for t in res.trials]


def phase_search(dev):
    from repro_torch.core.hass import hass_search
    from repro_torch.kernels import launch_counts
    from repro_torch.search_run import search_compare
    payload = search_compare(iters=16, img_res=RESNET18_IMG_RES, seed=0,
                             budget=12234, batch_size=SEARCH_BATCH,
                             device=dev, train_steps=20)
    ev = payload["ev"]
    L = len(ev.prunable)
    if L != 21:
        fail(f"ResNet-18 should have 21 prunable layers, found {L}")
    # gate (c): two 16-trial searches of 8 per round built exactly one shape
    if ev.batch_shapes != {SEARCH_BATCH} or ev.padded_batches or \
            set(ev._graphs) != {(False, SEARCH_BATCH)}:
        fail(f"the 16-trial searches built shapes {ev.batch_shapes} "
             f"(graphs {sorted(ev._graphs)}, {ev.padded_batches} padded)")
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
    # 16 + 16 + 4 + 4 trials and the dense proposal: 41 proposals in 2 + 2
    # batched passes and 4 + 4 + 1 serial ones, each pass one launch of the
    # batched entry per prunable layer
    counts = launch_counts()
    launches = counts["act_clip_count_batched"]
    if launches != 21 * ev.stats_passes or ev.stats_passes != 13 or \
            counts["act_clip_count"] or ev.stats_forwards != 41:
        fail(f"act_clip_count launches {counts} != 21 x {ev.stats_passes} "
             f"stats passes (13 expected) through the batched entry, "
             f"{ev.stats_forwards} proposals (41)")
    # the implicit-GEMM kernel: once per routed layer in each of the 4
    # batched passes, never in a serial one (one proposal stays on cuDNN)
    if counts["conv_igemm"] != IGEMM_LAYERS * 4:
        fail(f"conv_igemm launches {counts['conv_igemm']} != "
             f"{IGEMM_LAYERS} x 4 batched passes")
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
         setup_s=payload["setup_s"], warmup_s=payload["warmup_s"],
         search_s=payload["search_s"],
         trials_per_s=payload["trials_per_s"],
         serial_trials_per_s=4 / serial_s,
         stats_forwards=ev.stats_forwards, stats_passes=ev.stats_passes,
         act_clip_launches_per_pass=21,
         act_clip_launches=launches,
         conv_igemm_launches_per_pass=IGEMM_LAYERS,
         conv_igemm_launches=counts["conv_igemm"],
         graphs_captured=ev.graphs_captured, capture_s=ev.capture_s,
         graph_pool_bytes=ev.graph_pool_bytes,
         batch_shapes=sorted(ev.batch_shapes),
         one_shape_per_search=True,
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


def phase_search_gates(payload) -> dict:
    """Gates (a), (c) and (d) on the search phase's evaluator, with the
    launch counters set to 0 just before and read just after: every pass
    here is one launch of the batched entry per prunable layer."""
    from repro_torch import kernels
    from repro_torch.core.hass import hass_search
    ev = payload["ev"]
    L = len(ev.prunable)
    kernels.reset_launch_counts()
    passes0 = ev.stats_passes
    # (a) one captured replay == the same batched pass run eagerly
    rng = np.random.default_rng(11)
    s_w = rng.uniform(0.0, 0.9, (SEARCH_BATCH, L)).astype(np.float32)
    s_a = rng.uniform(0.0, 0.9, (SEARCH_BATCH, L)).astype(np.float32)
    replayed = ev._pass(s_w, s_a, None, SEARCH_BATCH)
    with torch.no_grad():
        eager = ev._device_pass(torch.from_numpy(s_w).to(ev.device),
                                torch.from_numpy(s_a).to(ev.device))
    eager = eager.cpu().numpy()
    replayed = np.concatenate([replayed[0][:, None], *replayed[1:]], 1)
    if not np.array_equal(replayed.view(np.int32), eager.view(np.int32)):
        fail("search_gates (a): a replayed pass differs from the same pass "
             "run eagerly")
    # (c) a ragged 3 + 3 + 2 search pads its tail to the shape it built
    shapes, padded, graphs = set(ev.batch_shapes), ev.padded_batches, \
        ev.graphs_captured
    ragged = hass_search(ev, L, iters=8, seed=4, batch_size=3)
    if len(ragged.trials) != 8 or ev.padded_batches <= padded or \
            ev.batch_shapes - shapes != {3} or \
            ev.graphs_captured != graphs + 1:
        fail(f"search_gates (c): the ragged search built "
             f"{ev.batch_shapes - shapes}, padded "
             f"{ev.padded_batches - padded} rounds")
    # (d) every batched trial against the same proposal through the serial
    # path, within the reference's bar
    worst, checked = 0.0, 0
    for res in (payload["hw_result"], payload["sw_result"], ragged):
        for t in res.trials:
            ms = ev(t.x)
            for k, v in ms.items():
                diff = abs(t.metrics[k] - v)
                if diff > max(1e-3 * abs(v), 1e-6):
                    fail(f"search_gates (d): batched {k}={t.metrics[k]} vs "
                         f"serial {v}")
                worst = max(worst, diff / max(abs(v), 1e-12))
            checked += 1
    torch.cuda.synchronize()
    # the evaluator's passes, and gate (a)'s eager pass beside them
    passes = ev.stats_passes - passes0 + 1
    counts = kernels.launch_counts()
    if counts["act_clip_count_batched"] != L * passes or \
            counts["act_clip_count"] or counts["block_sparse_matmul"] or \
            counts["conv_igemm"] != IGEMM_LAYERS * (passes - checked):
        fail(f"search_gates: launches {counts} over {passes} passes, "
             f"{checked} of them serial")
    return {"replay_equals_eager": True, "ragged_padded_rounds":
            ev.padded_batches - padded, "ragged_new_shapes": [3],
            "trials_checked_against_serial": checked,
            "worst_rel_diff": worst, "tolerance": "rel 1e-3 / abs 1e-6",
            "passes": passes, "launches": counts,
            "graphs_captured": ev.graphs_captured,
            "graph_pool_bytes": ev.graph_pool_bytes,
            "capture_s": ev.capture_s}


def phase_patterns(payload, factors) -> dict:
    """The search phase's configuration with the pattern axis (16 trials, 8
    per round, seed 0, each arm its own evaluator): the degenerate axis must
    replay the search phase's hardware-aware transcript bit for bit (gate 1
    of benchmarks/sparsity_bench.py), and the four-pattern arm, priced by
    the card's decode factors, must report ``meas`` on every trial."""
    from repro_torch import kernels
    from repro_torch.search_run import pattern_compare
    kernels.reset_launch_counts()
    out = pattern_compare(payload["ev"], factors, iters=16, seed=0,
                          batch_size=8, meas=0.05)
    counts = kernels.launch_counts()
    if transcript(out["unstructured"]["result"]) != \
            transcript(payload["hw_result"]):
        fail("patterns: the ('unstructured',) axis did not replay the "
             "search phase's transcript")
    res = out["patterns"]["result"]
    if len(res.trials) != 16 or \
            not all("meas" in t.metrics for t in res.trials):
        fail("patterns: a pattern trial did not report meas")
    forwards = sum(out[a]["ev"].stats_forwards
                   for a in ("unstructured", "patterns"))
    passes = sum(out[a]["ev"].stats_passes
                 for a in ("unstructured", "patterns"))
    if counts["act_clip_count_batched"] != 21 * passes or \
            counts["act_clip_count"] or forwards != 32 or passes != 4 or \
            counts["conv_igemm"] != IGEMM_LAYERS * passes:
        fail(f"patterns: act_clip_count launches {counts} over {passes} "
             f"stats passes of {forwards} proposals")
    best = res.best_metrics
    picked = [r["pattern"] for r in out["best_assignment"]]
    return {"model": "resnet18", "img_res": RESNET18_IMG_RES, "iters": 16,
            "batch_size": 8, "replays_search_transcript": True,
            "pattern_costs": dict(factors), "meas_weight": 0.05,
            "trials_per_s": {a: out[a]["trials_per_s"]
                             for a in ("unstructured", "patterns")},
            "best": {k: best[k] for k in
                     ("acc", "spa", "thr", "dsp", "eff", "meas", "score")},
            "unstructured_best": {
                k: out["unstructured"]["result"].best_metrics[k]
                for k in ("acc", "spa", "thr", "dsp", "eff", "score")},
            "pattern_counts": {p: picked.count(p) for p in sorted(set(picked))},
            "best_assignment": out["best_assignment"],
            "stats_forwards": forwards, "stats_passes": passes,
            "graph_pool_bytes": {a: out[a]["ev"].graph_pool_bytes
                                 for a in ("unstructured", "patterns")},
            "capture_s": {a: out[a]["ev"].capture_s
                          for a in ("unstructured", "patterns")},
            "launches": counts}


def phase_timing(rows, budget_ms: float = 30.0, plain: bool = True):
    """The execute step's products again, on the same operands, timed:
    the kernel and one library ``x @ w`` each in a CUDA graph, beside the
    bound; with ``plain``, also the eager wrapper and the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bench_util import (device_ms, matmul_bound_ms,
                                                time_ms)
    keys = ("ms", "wrapper_ms", "plain_ms") if plain else ("ms",)
    out, tot = [], dict.fromkeys(keys + ("library_ms", "bound_ms",
                                         "ops_bound_ms"), 0.0)
    for r in rows:
        sw, x, wp = r["operands"]
        bound, by = matmul_bound_ms(sw, x.shape[0], x.element_size())
        t = {"ms": matmul_device_ms(sw, x, budget_ms=budget_ms)}
        if plain:
            t["wrapper_ms"] = time_ms(lambda: sw.matmul(x),
                                      budget_ms=budget_ms)
            t["plain_ms"] = time_ms(lambda: ref.block_sparse_matmul_ref(
                x, wp, sw.mask, sw.bk, sw.bn), budget_ms=budget_ms)
        t["library_ms"] = device_ms(lambda: torch.matmul(x, wp),
                                    budget_ms=budget_ms)
        out.append({"layer": r["layer"], "x": r["x"], "M": r["M"],
                    "K": r["K"], "N": r["N"], "steps": r["schedule_steps"],
                    "dense_steps": r["dense_steps"], **t,
                    "bound_ms": bound,
                    "bound_by": by, "plan": plan_of(sw, x.shape[0])})
        for k, v in t.items():
            tot[k] += v
        tot["bound_ms"] += bound
        tot["ops_bound_ms"] += bound if by == "operations" else 0.0
    by = "operations" if tot["ops_bound_ms"] >= 0.5 * tot["bound_ms"] \
        else "bytes"
    return out, tot, by


def device_ops(fn) -> list:
    """Names of the device operations one ``fn()`` runs (profiler trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:60] for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def busy_us(prof) -> tuple:
    """(busy microseconds, kernel count): the union of the device
    operations' intervals in a torch.profiler trace."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def _busy_over_steps(step, n: int = 8) -> dict:
    """The device's busy share over ``n`` calls of ``step`` (one decode
    step each), from a torch.profiler trace over the host-clock window, or
    "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:               # the profiler cannot trace
        return {"device_busy_share": "not measured", "reason": str(e)}
    t0 = time.perf_counter()
    try:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    finally:
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.stop()
    b_us, n_k = busy_us(prof)
    if not n_k or b_us <= 0:
        return {"device_busy_share": "not measured",
                "reason": "the trace holds no device time"}
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name[:60], [0.0, 0])
            t[0] += e.time_range.elapsed_us()
            t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_busy_share": b_us / wall_us, "busy_ms": b_us / 1e3,
            "window_ms": wall_us / 1e3, "device_ops": n_k,
            "device_ops_per_step": n_k / n,
            # the costliest device operations: [us, launches] per step
            "top_ops_per_step": {k: [v[0] / n, v[1] / n] for k, v in top}}


def phase_profile(payload, rows) -> dict:
    """The device's busy share over one batched round of the search (8
    proposals, after one warm-up round): the union of the kernels' intervals
    in a torch.profiler trace over the host-clock window. The profiler's own
    host cost is inside the window, so the share reads low."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hass import hass_search
    ev = payload["ev"]
    L = len(ev.prunable)
    hass_search(ev, L, iters=8, seed=2, batch_size=8)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:       # the profiler cannot trace the card
        return {"device_busy_share": "not measured", "reason": str(e)}
    # the round itself runs outside any try: what it raises ends the script
    t0 = time.perf_counter()
    try:
        hass_search(ev, L, iters=8, seed=3, batch_size=8)
        torch.cuda.synchronize()
    finally:
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.stop()
    busy, n_kernels = busy_us(prof)
    if not n_kernels or busy <= 0:
        return {"device_busy_share": "not measured",
                "reason": "the trace holds no device time"}
    # one call of each wrapper as the main path makes it: nothing but the
    # kernel (and the matmul's split reduction) runs on the device
    from repro_torch.kernels import ops
    x = torch.relu(torch.randn((8, 56, 56, 8 * 64), device="cuda"))
    taus = torch.full((8,), 0.3, device="cuda")
    sw, xm, _ = rows[9]["operands"]          # a split-K product
    per_call = {"ops.act_clip_batched": device_ops(
                    lambda: ops.act_clip_batched(x, taus)),
                "SparseWeight.matmul": device_ops(lambda: sw.matmul(xm))}
    return {"device_busy_share": busy / wall_us, "busy_ms": busy / 1e3,
            "window_ms": wall_us / 1e3, "kernels": n_kernels,
            "proposals": 8, "device_ops_per_call": per_call}


PAPER_ITERS = 8            # hardware-aware TPE trials per model (the smoke
                           # t2_iters of benchmarks/run.py)


def _clip_per_forward(cfg, dev, gen) -> dict:
    """One serial stats pass's clip inputs for ``cfg`` at 224 x 224 (8
    images, one proposal), each through the batched entry as the paper's
    passes call it, held against the plain version bit for bit (counts
    too), then timed (device time in a CUDA graph, summed over the
    inputs)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bench_util import (clip_bound_ms, device_ms,
                                                main_path_clip_shapes)
    taus, ms, bound = torch.tensor([0.3], device=dev), 0.0, 0.0
    shapes = main_path_clip_shapes(CALIB_BATCH, cfg)
    for name, shape in shapes:
        x = torch.relu(torch.randn(shape, generator=gen)).to(dev)
        y, cnt = ops.act_clip_batched(x, taus)
        y_ref, cnt_ref = ref.act_clip_count_batched_ref(x, taus)
        if not torch.equal(_bits(y), _bits(y_ref)) or \
                not torch.equal(cnt, cnt_ref):
            fail(f"paper: act_clip_count_batched != plain at {cfg.name} "
                 f"{name} {shape}")
        ms += device_ms(lambda: ops.act_clip_batched(x, taus),
                        budget_ms=20.0)
        bound += clip_bound_ms(x, 1)[0]
    return {"inputs": len(shapes), "proposals": 1, "ms": ms,
            "bound_ms": bound}


def phase_paper(dev) -> dict:
    """Table II on the card: ``benchmarks_torch.table2_models.row`` for each
    of the five paper CNNs at its published widths and 224 x 224 (8
    calibration images, its Table II budget, PAPER_ITERS hardware-aware TPE
    trials), then the winner through ``execute_winner`` (every product
    within 1e-4 of the plain version). The launch counters are set to 0
    just before each model and read just after its execute step; gates:
    act_clip_count launches == prunable layers x stats forwards,
    block_sparse_matmul launches == products, the dense proposal scores
    acc 1.0, every trial's metrics in range. Then each product is timed as
    ``phase_timing`` does (kernel, library, bound; summed per model) and one
    stats forward's clip inputs are checked and timed. Before each model,
    its SGD warm-up (``trained_cnn``: one captured step, replayed), the
    same warm-up eagerly and captured once more must give the same weights
    bit for bit; ``warmup_s`` times the first (the main path's, which
    ``model_s`` counts), ``eager_warmup_s`` and
    ``captured_warmup_again_s`` the other two, after the first has picked
    the convolutions' algorithms."""
    from benchmarks_torch.common import calib_images, trained_cnn
    from benchmarks_torch.table2_models import BUDGETS, row
    from repro_torch import kernels
    from repro_torch.configs.paper_cnns import PAPER_CNNS
    from repro_torch.search_run import execute_winner
    gen = torch.Generator(device="cpu")
    gen.manual_seed(17)
    models, launches, max_err, warm = [], dict.fromkeys(
        kernels.launch_counts(), 0), 0.0, {}
    for cfg in PAPER_CNNS:
        # the warm-up as the main path runs it (captured once, replayed;
        # the first convolutions of each shape pick their algorithms here),
        # then eagerly and captured again from the same seed: the weights
        # must be the same bits
        warmup_s = _timed_step(lambda: warm.update(
            p=trained_cnn(cfg, steps=20, device=dev))) / 1e3
        params = warm.pop("p")
        again = {}
        for tag, graph in (("eager", False), ("captured", True)):
            again[tag] = _timed_step(lambda: warm.update(
                p=trained_cnn(cfg, steps=20, device=dev,
                              graph=graph))) / 1e3
            for n, d in warm.pop("p").items():
                for k, v in d.items():
                    if not _bits_equal(params[n][k], v):
                        fail(f"paper: {cfg.name}'s {tag} warm-up != the "
                             f"captured warm-up at {n}/{k}")
        t0 = time.perf_counter()
        images = calib_images(cfg.img_res, 0, n=CALIB_BATCH, device=dev)
        kernels.reset_launch_counts()
        r, ev, res = row(cfg, params, images, BUDGETS[cfg.name], PAPER_ITERS,
                         cost_cfg=cfg, seed=0)
        L = len(ev.prunable)
        dense = ev(np.zeros(2 * L))
        prods = execute_winner(ev, res.best_x, max_m=MAX_M,
                               keep_operands=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        model_s = warmup_s + time.perf_counter() - t0
        if dense["acc"] != 1.0:
            fail(f"paper: {cfg.name}'s unpruned proposal scored acc "
                 f"{dense['acc']}, not 1.0")
        bad = [p["layer"] for p in prods if not p["ok"]]
        if bad or len(prods) != L + 1:
            fail(f"paper: {cfg.name}: {len(prods)} products for {L} prunable "
                 f"layers, disagreeing with plain: {bad}")
        if counts["act_clip_count_batched"] != L * ev.stats_passes or \
                counts["act_clip_count"] or \
                ev.stats_passes != PAPER_ITERS + 1 or \
                ev.stats_forwards != PAPER_ITERS + 1:
            fail(f"paper: {cfg.name}: act_clip_count launches {counts} != "
                 f"{L} x {ev.stats_passes} stats passes of "
                 f"{ev.stats_forwards} proposals through the batched entry")
        if counts["block_sparse_matmul"] != len(prods):
            fail(f"paper: {cfg.name}: block_sparse_matmul launches "
                 f"{counts['block_sparse_matmul']} != {len(prods)} products")
        if counts["conv_igemm"]:
            fail(f"paper: {cfg.name}: its serial passes launched conv_igemm "
                 f"{counts['conv_igemm']} times (one proposal is cuDNN's)")
        for t in res.trials:
            m = t.metrics
            if not (np.isfinite(t.score) and 0.0 <= m["acc"] <= 1.0
                    and 0.0 <= m["spa"] <= 1.0 and m["thr"] > 0
                    and 0.0 < m["dsp"] <= 1.0 + 1e-9 and len(t.x) == 2 * L):
                fail(f"paper: {cfg.name}: a trial's metrics are out of "
                     f"range: {m}")
        for k in launches:
            launches[k] += counts[k]
        err = max(p["max_abs_err"] for p in prods)
        max_err = max(max_err, err)
        # the products again, on the same operands, timed (not counted)
        timed_rows, tot, by = phase_timing(prods, budget_ms=20.0, plain=False)
        matmul = {"ms": tot["ms"], "library_ms": tot["library_ms"],
                  "bound_ms": tot["bound_ms"], "bound_by": by}
        w = max(timed_rows, key=lambda t: t["ms"] - t["library_ms"])
        worst = {"layer": w["layer"], "x": w["x"],
                 "MKN": [w["M"], w["K"], w["N"]], "ms": w["ms"],
                 "library_ms": w["library_ms"],
                 "loss_ms": w["ms"] - w["library_ms"], "plan": w["plan"]}
        clip = _clip_per_forward(cfg, dev, gen)
        models.append({
            "model": cfg.name, "img_res": cfg.img_res, "budget":
            BUDGETS[cfg.name], "iters": PAPER_ITERS, "prunable_layers": L,
            **{k: r[k] for k in ("eff_ratio", "dense_images_s",
                                 "sparse_images_s", "dense_eff_e9",
                                 "sparse_eff_e9", "acc_proxy", "spa",
                                 "search_s")},
            "trials_per_s": PAPER_ITERS / r["search_s"],
            "stats_forwards": ev.stats_forwards,
            "stats_passes": ev.stats_passes, "launches": counts,
            "products": len(prods),
            "schedule_steps": sum(p["schedule_steps"] for p in prods),
            "dense_steps": sum(p["dense_steps"] for p in prods),
            "max_abs_err": err, "matmul": matmul,
            "largest_loss_to_library": worst, "clip_per_forward": clip,
            "warmup_s": warmup_s, "eager_warmup_s": again["eager"],
            "captured_warmup_again_s": again["captured"],
            "warmup_bitwise_equal": True, "model_s": model_s})
        del params, images, ev, res, prods
        gc.collect()
        torch.cuda.empty_cache()
    return {"models": models, "launches": launches, "max_abs_err": max_err,
            "tolerance": "allclose atol=rtol=1e-4 (f32)"}


SERVE_ARCH = "qwen3-0.6b"
SERVE_SLOTS, SERVE_S_MAX = 8, 256
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 16, 128, 64
TF_TOKENS, TF_SPLIT = 1300, 1268        # teacher-forcing gate (float32)


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def gate_teacher_forcing(cfg32, params, dev) -> float:
    """Float32 prefill + 32 teacher-forced decode steps against the
    full-sequence forward over 1,300 tokens (blockwise attention's ragged
    tail at full width: 1,300 > 2 x 512). Returns the largest
    max|dlogits| / max|logits| over the 33 positions."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    api = build_model(cfg32)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size,
                                        size=(2, TF_TOKENS)), device=dev)
    ref = tfm.lm_forward(cfg32, params, toks)[1][:, TF_SPLIT - 1:].clone()
    last, cache = api.prefill(params, toks[:, :TF_SPLIT], TF_TOKENS)
    got = [last[:, 0]]
    for t in range(TF_SPLIT, TF_TOKENS):
        lg, cache = api.decode_step(params, cache, toks[:, t:t + 1])
        got.append(lg[:, 0])
    got = torch.stack(got, dim=1)                         # (2, 33, V)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        fail(f"serve: decode logits {tuple(got.shape)} vs {tuple(ref.shape)}"
             " or not finite")
    ratio = float(((got - ref).abs().amax(dim=(0, 2))
                   / ref.abs().amax(dim=(0, 2))).max())
    if ratio > 1e-3:
        fail(f"serve: float32 decode differs from teacher forcing by "
             f"{ratio:.3e} x max|logits| (limit 1e-3)")
    return ratio


def gate_ragged_rows(api32, params, dev) -> None:
    """Pad-to-max + mask: a row's greedy tokens do not depend on what
    shares its batch (float32)."""
    from repro_torch.serve.serve_loop import ServeSession
    sess = ServeSession(api32, params, batch_slots=SERVE_SLOTS,
                        S_max=SERVE_S_MAX, device=dev)
    rng = np.random.default_rng(2)
    long = rng.integers(0, api32.cfg.vocab_size, size=100)
    short = rng.integers(0, api32.cfg.vocab_size, size=37)
    alone = sess.generate([long], max_new=8)[0]
    with_short = sess.generate([long, short], max_new=8)[0]
    swapped = sess.generate([short, long], max_new=8)
    short_alone = sess.generate([short], max_new=8)[0]
    if not (with_short == alone == swapped[1] and swapped[0] == short_alone):
        fail("serve: a ragged batch's row depends on its companions: "
             f"{alone} {with_short} {swapped} {short_alone}")


@torch.no_grad()
def replay_vs_eager(sess, prompts, kw, steps: int = 8) -> dict:
    """One prefill of ``prompts`` decoded ``steps`` replayed steps through
    the session's buffer set and, from a copy of the same cache, through
    ``api.decode_step`` eagerly, both fed the eager step's greedy token. A
    new set's first step captures its graph (that step runs eagerly on a
    side stream) and is compared too. Per step the logits bit for bit (the
    largest difference / max |logits| where they differ), every cache leaf
    after the last step; CUDA events time each call on the stream."""
    api = sess.api
    logits, cache, _ = sess._prefill_groups(prompts, kw)
    eager = {k: v.clone() for k, v in cache.items()}
    captured = sess.graphs_captured
    ds = sess.decode_set(cache)
    del cache
    first = int(ds.graph is None)
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    equal, worst, ev = True, 0.0, []
    for i in range(steps + first):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        want, eager = api.decode_step(sess.params, eager, cur)
        e[1].record()
        got = ds.step(cur)
        e[2].record()
        if i >= first:
            ev.append(e)
        if not _bits_equal(got, want):
            equal = False
            worst = max(worst, float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()))
        cur = torch.argmax(want[:, -1], -1)[:, None]
    torch.cuda.synchronize()
    leaves = {k: _bits_equal(ds.cache[k], eager[k]) for k in eager}
    for k, ok in leaves.items():
        if not ok and eager[k].is_floating_point():
            worst = max(worst, float((ds.cache[k].float() - eager[k].float())
                                     .abs().max()
                                     / eager[k].float().abs().max()))
    eager_ms = sorted(e[0].elapsed_time(e[1]) for e in ev)
    replay_ms = sorted(e[1].elapsed_time(e[2]) for e in ev)
    return {"replayed_steps": steps, "logits_bit_equal": equal,
            "cache_bit_equal": all(leaves.values()),
            "cache_leaves": sorted(leaves), "max_rel_diff": worst,
            "captured_here": sess.graphs_captured - captured,
            "eager_ms_per_step": eager_ms[len(eager_ms) // 2],
            "replay_ms_per_step": replay_ms[len(replay_ms) // 2]}


SERVE_FAMILIES = {"qwen3-0.6b": "dense GQA, qk-norm",
                  "mixtral-8x7b": "MoE, sliding-window ring cache",
                  "deepseek-v3-671b": "MLA + MoE",
                  "zamba2-1.2b": "Mamba2 + shared attention",
                  "rwkv6-1.6b": "RWKV6 recurrence",
                  "whisper-base": "encoder-decoder"}


def phase_serve_families(dev, card) -> dict:
    """Every LM family at ``reduce_config`` size through its session's
    decode program on the card: a buffer set captured from a 6-token
    prefill, then 8 replayed steps bit-equal to ``api.decode_step`` run
    eagerly (Mixtral's 8-slot ring wraps), every cache leaf too."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serve.serve_loop import ServeSession
    kernels.reset_launch_counts()
    out = {}
    for arch, family in SERVE_FAMILIES.items():
        cfg = reduce_config(get_config(arch))
        api = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        sess = ServeSession(api, api.init(gen, device=dev), batch_slots=2,
                            S_max=32, device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=6) for _ in range(2)]
        kw = {"frames": rng.normal(size=(2, cfg.num_frames, cfg.d_model))
              .astype(np.float32)} if cfg.is_encoder_decoder else {}
        r = replay_vs_eager(sess, prompts, kw)
        if not (r["logits_bit_equal"] and r["cache_bit_equal"]
                and r["captured_here"] == 1 == sess.graphs_captured):
            fail(f"serve_families: {arch}'s replayed step != the eager "
                 f"step: {r}")
        out[arch] = {"family": family, "dtype": cfg.dtype,
                     "layers": cfg.num_layers, "d_model": cfg.d_model, **r,
                     "graphs_captured": sess.graphs_captured,
                     "capture_s": sess.capture_s,
                     "graph_pool_bytes": sess.graph_pool_bytes}
        del sess
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"serve_families: an SPE kernel was launched: {launches}")
    return {"card": card, "families": out, "spe_kernel_launches": launches}


def phase_serve(dev, card) -> dict:
    """Qwen3-0.6B at full width through ServeSession (see the module
    docstring). Every gate fails the script."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.bench_util import lm_serve_bounds, tree_numel
    from repro_torch.models import build_model
    from repro_torch.serve.serve_loop import ServeSession, requests_from_trace
    from repro_torch.sim.trace import backlogged_trace

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    cfg = get_config(SERVE_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, device=dev)        # float32
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tree_numel(params)

    kernels.reset_launch_counts()
    tf_ratio = gate_teacher_forcing(cfg32, params, dev)
    gate_ragged_rows(build_model(cfg32), params, dev)

    api = build_model(cfg)
    sess = ServeSession(api, params, batch_slots=SERVE_SLOTS,
                        S_max=SERVE_S_MAX, device=dev)
    bounds = lm_serve_bounds(cfg, params, batch=SERVE_SLOTS,
                             prompt_len=SERVE_PROMPT,
                             kv_rows=SERVE_PROMPT + SERVE_NEW / 2)
    del params                        # the session keeps its bf16 copy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    serve_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    reqs = requests_from_trace(backlogged_trace(SERVE_REQUESTS, SERVE_NEW),
                               vocab_size=cfg.vocab_size,
                               prompt_len=SERVE_PROMPT, seed=0)
    prompts = [r.prompt for r in reqs]
    toks = torch.as_tensor(np.stack(prompts[:SERVE_SLOTS]), device=dev)
    with torch.no_grad():
        # warm-up: first calls set up the libraries' handles and workspaces
        lg, cache = api.prefill(sess.params, toks, SERVE_S_MAX)
        for _ in range(3):
            lg, cache = api.decode_step(sess.params, cache,
                                        torch.argmax(lg[:, -1], -1)[:, None])
        prefill_ms = sorted(
            _sync_ms(lambda: api.prefill(sess.params, toks, SERVE_S_MAX))
            for _ in range(5))
        # decode steps one by one, CUDA events around each (a step's time
        # on the stream, host gaps included)
        lg, cache = api.prefill(sess.params, toks, SERVE_S_MAX)
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(SERVE_NEW)]
        ev[0].record()
        for i in range(1, SERVE_NEW):
            lg, cache = api.decode_step(sess.params, cache, cur)
            cur = torch.argmax(lg[:, -1], -1)[:, None]
            ev[i].record()
        torch.cuda.synchronize()
        step_ms = sorted(ev[i - 1].elapsed_time(ev[i])
                         for i in range(1, SERVE_NEW))
        del lg, cache

    # the workload: 16 requests through generate, twice; the first call
    # captures the decode step of its shape, the second only replays it
    t0 = time.perf_counter()
    outs = sess.generate(reqs, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = sess.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    if n_tok != SERVE_REQUESTS * SERVE_NEW or \
            not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        fail(f"serve: generate gave {n_tok} tokens or tokens out of range")
    if again != outs:
        fail("serve: two greedy bfloat16 generate calls differ")
    # the open loop on a backlogged trace issues generate's model calls
    rep = sess.serve_open_loop(
        requests_from_trace(backlogged_trace(SERVE_REQUESTS, SERVE_NEW),
                            vocab_size=cfg.vocab_size,
                            prompt_len=SERVE_PROMPT, seed=0),
        step_cycles=1.0, prefill_cycles=1.0)
    if rep.outputs != outs:
        fail("serve: serve_open_loop on a backlogged trace != generate")
    if rep.decode_steps != (SERVE_REQUESTS // SERVE_SLOTS) * (SERVE_NEW - 1):
        fail(f"serve: the open loop issued {rep.decode_steps} decode steps")
    peak = torch.cuda.max_memory_allocated()

    # gate (a): the session's replayed step == api.decode_step run eagerly
    # from the same prefill, bit for bit (else within the teacher-forcing
    # gate's 1e-3 x max |logits|, and said so)
    replay = replay_vs_eager(sess, prompts[:SERVE_SLOTS], {})
    exact = replay["logits_bit_equal"] and replay["cache_bit_equal"]
    if replay["captured_here"] or (not exact
                                   and replay["max_rel_diff"] > 1e-3):
        fail(f"serve: the replayed decode step differs from the eager step "
             f"(limit 1e-3 x max|logits|): {replay}")
    # the replayed step timed one by one as the eager step was, and its
    # device operations and busy share over 8 steps
    with torch.no_grad():
        lg, cache, _ = sess._prefill_groups(prompts[:SERVE_SLOTS], {})
        ds = sess.decode_set(cache)
        del cache
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(SERVE_NEW)]
        ev[0].record()
        for i in range(1, SERVE_NEW):
            cur = torch.argmax(ds.step(cur)[:, -1], -1)[:, None]
            ev[i].record()
        torch.cuda.synchronize()
        graph_ms = sorted(ev[i - 1].elapsed_time(ev[i])
                          for i in range(1, SERVE_NEW))
        lg, cache, _ = sess._prefill_groups(prompts[:SERVE_SLOTS], {})
        ds = sess.decode_set(cache)
        del cache
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        graph_busy = _busy_over_steps(
            lambda: torch.argmax(ds.step(cur)[:, -1], -1)[:, None])

    # the device's busy share over 8 eager decode steps
    with torch.no_grad():
        lg, cache = api.prefill(sess.params, toks, SERVE_S_MAX)
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        lg, cache = api.decode_step(sess.params, cache, cur)
        state = {"cache": cache}

        def eager_step():
            lg, state["cache"] = api.decode_step(sess.params, state["cache"],
                                                 cur)
            return torch.argmax(lg[:, -1], -1)[:, None]
        busy = _busy_over_steps(eager_step)
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"serve: the serving path launched an SPE kernel: {launches}")

    med = step_ms[len(step_ms) // 2]
    record = {"card": card, "model": cfg.name, "dtype": cfg.dtype,
              "params": n_params, "init_s": init_s,
              "batch_slots": SERVE_SLOTS, "S_max": SERVE_S_MAX,
              "requests": SERVE_REQUESTS, "prompt_len": SERVE_PROMPT,
              "max_new": SERVE_NEW,
              "teacher_forcing_max_rel_err": tf_ratio,
              "teacher_forcing_limit": 1e-3,
              "open_loop_equals_generate": True, "deterministic": True,
              "ragged_rows_independent": True,
              "prefill_ms": prefill_ms[len(prefill_ms) // 2],
              "prefill_ms_min_max": [prefill_ms[0], prefill_ms[-1]],
              "prefill_bound_ms": bounds["prefill_bound_ms"],
              "prefill_bound_by": bounds["prefill_bound_by"],
              "decode_ms_per_step": med,
              "decode_ms_p10_p90": [step_ms[len(step_ms) // 10],
                                    step_ms[(9 * len(step_ms)) // 10]],
              "decode_ms_min_max": [step_ms[0], step_ms[-1]],
              "decode_step_bound_ms": bounds["decode_step_bound_ms"],
              "decode_bound_by": bounds["decode_bound_by"],
              "decode_ms_per_step_graph": graph_ms[len(graph_ms) // 2],
              "decode_ms_graph_p10_p90": [
                  graph_ms[len(graph_ms) // 10],
                  graph_ms[(9 * len(graph_ms)) // 10]],
              "decode_ms_graph_min_max": [graph_ms[0], graph_ms[-1]],
              "replay_vs_eager": replay,
              "replay_bit_equal": exact,
              "graphs_captured": sess.graphs_captured,
              "capture_s": sess.capture_s,
              "graph_pool_bytes": sess.graph_pool_bytes,
              "buffer_sets": sum(sess.buffer_sets.values()),
              "generate_s": gen_s, "tokens_per_s": n_tok / gen_s,
              "generate_replay_only_s": again_s,
              "tokens_per_s_replay_only": n_tok / again_s,
              "tokens_per_s_bound": SERVE_SLOTS
              / (bounds["decode_step_bound_ms"] / 1e3),
              "peak_allocated_bytes": peak,
              "peak_above_weights_bytes": peak - serve_base,
              "session_bytes": serve_base - base_bytes,
              **busy, "graph_profile": graph_busy,
              "spe_kernel_launches": launches}
    return sess, record


FLEET_REPLAY = 12          # requests of the busiest replica replayed


def phase_fleet(sess) -> dict:
    """The serve phase's session (Qwen3-0.6B, bf16, 8 slots) through
    ``serve_open_loop`` twice, each run's admission and completion clocks
    held bit for bit against ``fleet.open_loop_schedule``:

    1. act 3 of ``examples/fleet_serve.py`` at full width: an autoscale
       policy search (32 trials, up to 4 replicas) over a seeded MMPP trace
       of 4,000 requests, then the first ``FLEET_REPLAY`` requests that its
       fleet routed to the busiest replica, at their routing times;
    2. a degraded step schedule (three rungs, a switch stall) with
       per-request deadlines, the form of ``tests/test_fleet.py``'s
       ``test_degraded_schedule_is_exact_timing_twin``."""
    from repro_torch.serve.fleet import open_loop_schedule
    from repro_torch.serve.serve_loop import Request, requests_from_trace
    from repro_torch.sim import Trace, autoscale_policy_search, mmpp_trace
    vocab = sess.api.cfg.vocab_size
    out = {}

    def served(tag, reqs, rep, adm, comp, **extra):
        if not (np.array_equal(rep.admissions, adm)
                and np.array_equal(rep.completions, comp)):
            fail(f"fleet {tag}: serve_open_loop's clocks differ from "
                 f"fleet.open_loop_schedule's")
        if rep.shed + rep.completed != len(reqs):
            fail(f"fleet {tag}: {rep.shed} shed + {rep.completed} completed "
                 f"!= {len(reqs)}")
        for r, o, shed in zip(reqs, rep.outputs, rep.shed_mask):
            if len(o) != (0 if shed else r.max_new) or \
                    not all(0 <= t < vocab for t in o):
                fail(f"fleet {tag}: a request emitted {len(o)} tokens")
        out[tag] = {"requests": len(reqs), "completed": rep.completed,
                    "shed": rep.shed, "prefills": rep.prefills,
                    "decode_steps": rep.decode_steps,
                    "p50_cycles": rep.p50, "p99_cycles": rep.p99,
                    "clocks_equal_open_loop_schedule": True, **extra}

    kw = dict(step_cycles=100.0, prefill_cycles=300.0)
    tr = mmpp_trace(4000, 2e-4, 1.5e-2, dwell_base=3e5, dwell_burst=8e4,
                    sizes=[8, 16], seed=0)
    t0 = time.perf_counter()
    pol, frep, base = autoscale_policy_search(
        tr, max_replicas=4, n_trials=32, seed=0, batch_slots=sess.B, **kw)
    search_s = time.perf_counter() - t0
    busiest = int(np.argmax(np.bincount(frep.assignment, minlength=4)))
    idx = np.flatnonzero(frep.assignment == busiest)[:FLEET_REPLAY]
    sub = Trace(frep.routed_at[idx] - frep.routed_at[idx].min(),
                tr.sizes[idx], kind=tr.kind)
    reqs = requests_from_trace(sub, vocab_size=vocab, prompt_len=8, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = sess.serve_open_loop(reqs, **kw)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    adm, comp = open_loop_schedule(sub.arrivals, sub.sizes,
                                   batch_slots=sess.B, **kw)
    served("replica_replay", reqs, rep, adm, comp, replica=busiest,
           policy=dataclasses.asdict(pol), fleet_p99_cycles=frep.p99,
           static_best=base["static_best"], policy_search_s=search_s,
           serve_s=serve_s, serve_s_per_decode_step=serve_s
           / max(1, rep.decode_steps))

    rng = np.random.default_rng(8)
    n = 16
    arr = np.cumsum(rng.exponential(250.0, n)).astype(float)
    new = rng.integers(4, 20, n).astype(float)
    dls = arr + rng.uniform(8e2, 8e3, n)
    sched = [(0.0, 1.0), (float(arr[5]), 0.6), (float(arr[11]), 0.85)]
    reqs = [Request(prompt=rng.integers(0, vocab, size=5),
                    max_new=int(new[i]), arrival=float(arr[i]),
                    deadline=float(dls[i])) for i in range(n)]
    dkw = dict(step_cycles=25.0, prefill_cycles=75.0, step_schedule=sched,
               switch_cycles=40.0)
    t0 = time.perf_counter()
    rep = sess.serve_open_loop(reqs, **dkw)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    adm, comp = open_loop_schedule(arr, new, batch_slots=sess.B,
                                   deadlines=dls, **dkw)
    served("degraded", reqs, rep, adm, comp,
           switch_stalls=rep.switch_stalls, serve_s=serve_s)
    return out


DRY_LAYERS = 2                      # the roofline twin's cell depth


def _dryrun_file(path: str, single_pod: bool = True,
                 layers: int = 0) -> dict:
    """One dry-run cell (qwen3-0.6b, train_4k, pod16x16 unless
    ``single_pod`` is false, at full depth unless ``layers`` cuts it, full
    width) in a process of its own on the ``fake`` backend, away from the
    card, written to ``path``: its sharded step run on one rank's meta
    shards and counted. Returns its record; fails unless the step ran and
    counted collectives."""
    key = "qwen3-0.6b|train_4k|" + ("pod16x16" if single_pod
                                    else "pod2x16x16") + \
        (f"|L{layers}" if layers else "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k",
         "--single-pod" if single_pod else "--multi-pod", "--out", path]
        + (["--layers", str(layers)] if layers else []),
        capture_output=True, text=True, timeout=420,
        env=dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES=""))
    if r.returncode != 0 or not os.path.exists(path):
        fail(f"the dry run failed: {r.stderr[-2000:]}")
    with open(path) as f:
        rec = json.load(f)[key]
    if rec.get("status") != "ok" or not rec.get("ran") or not (
            rec["collective_s"] and rec["collective_s"] > 0
            and rec["flops_per_device"] > 0 and rec["coll_by_op"]):
        fail(f"dry-run cell {key}: {rec}")
    return rec


def _obs_own_process(out_dir: str) -> dict:
    """``benchmarks_torch.obs_bench`` in the reference's full mode (its
    tracer-overhead gate the least of 5 paired ratios) in a process of its
    own, so that its two timed arms run in a fresh interpreter and not
    beside the heap and threads the earlier phases leave in this one. Its
    asserts are its gates; returns the payload it wrote to ``out_dir``."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.obs_bench", "--out-dir",
         out_dir], cwd=here, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, here))))
    if r.returncode != 0:
        fail(f"bench_twins: obs failed: {r.stdout[-1500:]} "
             f"{r.stderr[-1500:]}")
    print(r.stdout, end="", flush=True)
    with open(os.path.join(out_dir, "obs_bench_h100.json")) as f:
        return json.load(f)


def _example(name: str):
    """``examples/<name>.py`` as a module (the directory is no package)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bench_twins(dev) -> dict:
    """Six benchmark twins (roofline, lm_dse, sim, fleet, chaos, obs), each
    ``run(smoke=True, device=dev, out_dir=tmp)`` called directly but obs,
    which runs in full mode in a process of its own (``_obs_own_process``;
    module docstring), then
    ``examples/quickstart_torch.py`` on the card. Every job's own asserts
    are gates (nothing is caught); beside them: no job launches an SPE
    kernel; the roofline rows are the dry-run record; the fleet ``replay``
    and the chaos ``zero_fault`` and ``replay`` sections, whose serve path
    runs Qwen3-0.6B at full width in bf16 here, equal the same sections run
    on the CPU at ``reduce_config`` size; quickstart launches the clip's
    batched entry once per prunable layer per stats pass and its single
    entry once for its act 4, ``block_sparse_matmul`` at least once, and its
    product is within 1e-4 of the plain version."""
    from benchmarks_torch import (chaos_bench, fleet_bench, lm_dse_bench,
                                  roofline_report, sim_bench)
    from repro_torch import kernels
    from repro_torch.configs import get_config
    cpu = torch.device("cpu")
    full = get_config("qwen3-0.6b")
    jobs, sections = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dry_path = os.path.join(tmp, "dryrun_torch.json")
        t0 = time.perf_counter()
        dry = _dryrun_file(dry_path, layers=DRY_LAYERS)
        dry_s = time.perf_counter() - t0
        kw = dict(smoke=True, device=dev, out_dir=tmp)
        for name, job in (
                ("roofline", lambda: roofline_report.run(
                    path=dry_path, device=dev, out_dir=tmp)),
                ("lm_dse", lambda: lm_dse_bench.run(**kw)),
                ("sim", lambda: sim_bench.run(**kw)),
                ("fleet", lambda: fleet_bench.run(**kw)),
                ("chaos", lambda: chaos_bench.run(**kw)),
                ("obs", lambda: _obs_own_process(tmp))):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            payload = job()
            jobs[name] = {"seconds": time.perf_counter() - t0}
            launches = kernels.launch_counts()
            if any(launches.values()):
                fail(f"bench_twins: {name} launched an SPE kernel: "
                     f"{launches}")
            sections[name] = payload
        written = sorted(os.listdir(tmp))
    if sections["roofline"] != [dry] or dry["collective_s"] is None:
        fail(f"bench_twins: roofline rows {sections['roofline']} are not "
             f"the dry-run record, or it has no collective term")
    want = {f"{n}_h100.json" for n in ("lm_dse_bench", "sim_bench",
                                        "fleet_bench", "chaos_bench",
                                        "obs_bench", "obs_trace")}
    if not want <= set(written):
        fail(f"bench_twins: the jobs wrote {written}")

    # the serving sections against the same sections on the CPU
    t0 = time.perf_counter()
    _, winner = fleet_bench.bench_policy(True)
    cpu_sections = {
        "fleet.replay": fleet_bench.bench_replay(True, winner, cpu),
        "chaos.zero_fault": chaos_bench.bench_zero_fault(True, cpu),
        "chaos.replay": chaos_bench.bench_degraded_replay(True, cpu)}
    cpu_s = time.perf_counter() - t0
    card_sections = {"fleet.replay": sections["fleet"]["replay"],
                     "chaos.zero_fault": sections["chaos"]["zero_fault"],
                     "chaos.replay": sections["chaos"]["replay"]}
    for tag, got in card_sections.items():
        if got != cpu_sections[tag]:
            fail(f"bench_twins: {tag} on the card {got} != on the CPU "
                 f"{cpu_sections[tag]}")
    timing = {**{f"fleet.{k}": v for k, v in
                 sections["fleet"]["serve_timing"].items()},
              **{f"chaos.{k}": v for k, v in
                 sections["chaos"]["serve_timing"].items()}}
    for tag, t in timing.items():
        if t["device"] == "cpu" or t["layers"] != full.num_layers or \
                t["d_model"] != full.d_model or t["dtype"] != "bfloat16":
            fail(f"bench_twins: {tag} did not serve full-width Qwen3-0.6B "
                 f"in bf16 on the card: {t}")

    # quickstart on the card: both SPE kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q = _example("quickstart_torch").main(["--device", "cuda"])
    q_s = time.perf_counter() - t0
    q_launches = kernels.launch_counts()
    clip_want = q["prunable"] * q["stats_passes"]
    if q_launches["act_clip_count"] != 1 or \
            q_launches["act_clip_count_batched"] != clip_want or \
            q_launches["block_sparse_matmul"] < 1:
        fail(f"bench_twins: quickstart launched {q_launches}, expected "
             f"act_clip_count 1, act_clip_count_batched {clip_want} and "
             f"block_sparse_matmul >= 1")
    if not (q["max_abs_err_plain"] <= 1e-4 and q["max_abs_err"] <= 1e-4
            and q["clip_equals_plain"]):
        fail(f"bench_twins: quickstart's kernels disagree with their plain "
             f"versions: {q}")

    p = sections
    gates = {
        "roofline": {"rows": len(p["roofline"]),
                     "rows_equal_dry_run_record": True,
                     "collective_s": dry["collective_s"],
                     "coll_by_op": dry["coll_by_op"],
                     "run_s": dry["run_s"]},
        "lm_dse": {"worst_speedup": min(r["speedup"]
                                        for r in p["lm_dse"]["dse"]),
                   "gate": ">= 10"},
        "sim": {"worst_agreement_err": p["sim"]["worst_agreement_err"],
                "sim_tol": p["sim"]["sim_tol"],
                "slo_p99": p["sim"]["slo"]["slo"]["p99"],
                "maxmin_p99": p["sim"]["slo"]["maxmin"]["p99"]},
        "fleet": {"engine_speedup": p["fleet"]["engine_speedup"]["speedup"],
                  "engine_events": p["fleet"]["engine_speedup"]["events"],
                  "gate": ">= 10",
                  "searched_p99": p["fleet"]["policy"]["searched"]["p99"],
                  "searched_cost": p["fleet"]["policy"]["searched"]["cost"],
                  "replay_twin_identical":
                      p["fleet"]["replay"]["twin_identical"]},
        "chaos": {"zero_fault_consumers": len(p["chaos"]["zero_fault"]),
                  "aware_p99": p["chaos"]["search"]["aware_p99"],
                  "blind_p99": p["chaos"]["search"]["blind_p99"],
                  "degraded_shed": p["chaos"]["degrade"]["degraded_shed"],
                  "plain_shed": p["chaos"]["degrade"]["plain_shed"],
                  "switch_stalls": p["chaos"]["replay"]["switch_stalls"]},
        "obs": {"overhead_pct": p["obs"]["overhead"]["overhead_pct"],
                "gate_pct": p["obs"]["overhead_gate_pct"],
                "paired_ratios": p["obs"]["overhead"]["paired_ratios"],
                "trial_spans": p["obs"]["trace"]["trial_spans"],
                "same_seed_divergence":
                    p["obs"]["report"]["same_seed_divergence"]}}
    for name in jobs:
        jobs[name].update(ok=True, gates=gates[name])
    return {"jobs": jobs, "dry_run_s": dry_s,
            "serve_sections_equal_cpu": sorted(card_sections),
            "cpu_sections_s": cpu_s, "spe_kernel_launches": 0,
            "replay_serve": timing,
            "replay_decode_ms_per_step": {
                tag: t["ms_per_decode_step"] for tag, t in timing.items()},
            "quickstart": {"seconds": q_s, "launches": q_launches,
                           "act_clip_count_batched_expected": clip_want,
                           "prunable": q["prunable"],
                           "stats_forwards": q["stats_forwards"],
                           "stats_passes": q["stats_passes"],
                           "max_abs_err": q["max_abs_err"],
                           "max_abs_err_plain": q["max_abs_err_plain"],
                           "tolerance": 1e-4,
                           "tile_density": q["tile_density"],
                           "best_metrics": q["best_metrics"]}}


def phase_deploy() -> dict:
    """Host only: ``examples/deploy_sim_torch.py``'s flow at its defaults
    (Qwen3-0.6B ``LMEvaluator``, ``TPUModel(chips=4)``, 600 MMPP requests,
    ``objective="slo"``). On the run's trace the calendar engine's report
    must equal the heap engine's field for field, and every node's busy +
    blocked + idle + down time must add up to the horizon."""
    from repro_torch.deploy_run import deploy_compare
    from repro_torch.sim import simulate_partition
    t0 = time.perf_counter()
    d = deploy_compare()
    sl, tpu = d["slo_pick"], d["tpu"]
    if sl.objective != "slo" or sl.sim_report is None:
        fail("deploy: the SLO pick carries no sim_report")
    reps = {e: simulate_partition(d["layers"], tpu, sl, d["trace"], engine=e)
            for e in ("heap", "calendar")}
    for f in dataclasses.fields(reps["heap"]):
        a, b = getattr(reps["heap"], f.name), getattr(reps["calendar"],
                                                     f.name)
        if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b):
            fail(f"deploy: calendar != heap engine in SimReport.{f.name}")
    r = reps["calendar"]
    total = r.busy + r.blocked + r.idle + r.down
    if not np.allclose(total, r.horizon, rtol=1e-9):
        fail(f"deploy: busy + blocked + idle + down {total} != horizon "
             f"{r.horizon}")
    ms = 1e3 / tpu.freq
    return {"host_only": True, "model": d["cfg"].name, "chips": tpu.chips,
            "requests": len(d["trace"]), "trace": d["trace"].kind,
            "slo_p99_ms": d["slo"].target * ms,
            "picks": {tag: {"cuts": p.cuts,
                            "steady_tok_s": p.steady_throughput * tpu.freq,
                            "p50_ms": d["reports"][tag].p50 * ms,
                            "p99_ms": d["reports"][tag].p99 * ms}
                      for tag, p in (("maxmin", d["maxmin"]), ("slo", sl))},
            "calendar_equals_heap": True, "time_conserved": True,
            "slo_pick_s": d["slo_s"], "seconds": time.perf_counter() - t0}


TRAIN_ARCH = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 256
GATE_LAYERS, GATE_BATCH, GATE_SEQ = 2, 2, 64     # gates 2-4: depth cut to 2
DIST_STEPS = 4                      # timed sharded steps, after one warm-up


def train_tcfg():
    """The train phase's recipe: AdamW (float32 state), accum 2, remat
    "full"; the distributed phase and the sharded-equality gate run it too."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainConfig
    return TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=2,
                                     total_steps=16), accum=2, remat="full")


def _profile_step(step) -> dict:
    """The device's busy share over one ``step()`` (torch.profiler), its
    device operations, and the host operations with the most self time (the
    profiler's own cost included), or "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:                   # the profiler cannot trace
        return {"device_busy_share": "not measured", "reason": str(e)}
    t0 = time.perf_counter()
    try:
        step()
        torch.cuda.synchronize()
    finally:
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.stop()
    b_us, n_k = busy_us(prof)
    if not n_k or b_us <= 0:
        return {"device_busy_share": "not measured",
                "reason": "the trace holds no device time"}
    return {"device_busy_share": b_us / wall_us, "busy_ms": b_us / 1e3,
            "window_ms": wall_us / 1e3, "device_ops_per_step": n_k,
            "host_self_ms_top": [
                [e.key[:50], e.count, e.self_cpu_time_total / 1e3]
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:8]]}


def _to(tree, dev):
    """A copy of a tree of tensors / Packed8 on ``dev``."""
    from repro_torch.train.optimizer import Packed8
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, Packed8):
        return Packed8(_to(tree.q, dev), _to(tree.s, dev), tree.shape)
    return tree.detach().to(dev, copy=True)


def _leaf_pairs(a, b, path=""):
    from repro_torch.train.optimizer import Packed8
    if isinstance(a, dict):
        for k in a:
            yield from _leaf_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, Packed8):
        yield f"{path}/q", a.q, b.q
        yield f"{path}/s", a.s, b.s
    else:
        yield path, a, b


def _bits_equal(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = _bits(a), _bits(b)
    return torch.equal(a, b)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x, _ in
               _leaf_pairs(tree, tree))


def gate_card_vs_cpu(cfg32, dev) -> dict:
    """Float32 at full width, depth cut to 2: one ``compute_grads`` on the
    card and one on the CPU from the same parameters (loss within relative
    1e-5, each gradient leaf within 1e-4 x its max |g|), then one
    ``adamw_update`` on both sides from the CPU's gradients (parameters
    within 1e-6)."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, adamw_update, \
        init_opt_state
    from repro_torch.train.train_loop import TrainConfig, compute_grads
    api = build_model(cfg32)
    gen = torch.Generator()
    gen.manual_seed(1)
    p_cpu = api.init(gen, device="cpu")
    p_dev = _to(p_cpu, dev)
    batch = lm_batch(cfg32, GATE_BATCH, GATE_SEQ, seed=1, step=0,
                     device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=2,
                                     total_steps=16), accum=1, remat=None)
    g_dev, l_dev, _ = compute_grads(api.loss, tcfg, p_dev, _to(batch, dev))
    g_cpu, l_cpu, _ = compute_grads(api.loss, tcfg, p_cpu, batch)
    loss_rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    if not loss_rel <= 1e-5:
        fail(f"train: card loss {float(l_dev)} vs CPU {float(l_cpu)} "
             f"(relative {loss_rel:.3e}, limit 1e-5)")
    grad_worst = 0.0
    for path, gd, gc_ in _leaf_pairs(g_dev, g_cpu):
        scale = float(gc_.abs().max())
        err = float((gd.cpu() - gc_).abs().max())
        if not err <= 1e-4 * scale:
            fail(f"train: card gradient {path} differs from the CPU's by "
                 f"{err:.3e} (limit 1e-4 x {scale:.3e})")
        grad_worst = max(grad_worst, err / scale if scale else 0.0)
    adamw_update(p_cpu, g_cpu, init_opt_state(p_cpu, tcfg.opt), tcfg.opt)
    adamw_update(p_dev, _to(g_cpu, dev), init_opt_state(p_dev, tcfg.opt),
                 tcfg.opt)
    p_err = max(float((a.cpu() - b).abs().max())
                for _, a, b in _leaf_pairs(p_dev, p_cpu))
    if not p_err <= 1e-6:
        fail(f"train: card AdamW step differs from the CPU's by {p_err:.3e} "
             "(limit 1e-6)")
    return {"loss_rel_err": loss_rel, "grad_max_err_of_max": grad_worst,
            "adamw_param_max_err": p_err,
            "limits": {"loss_rel": 1e-5, "grad_of_max": 1e-4,
                       "param": 1e-6}}


def gate_accum_remat(cfg32, dev) -> dict:
    """Float32 at the gate size on the card: one step with accum 2 against
    accum 1 (parameters within 1e-5, the loss within relative 1e-5), and
    remat None / "full" / "dots" (losses within relative 1e-6), the bars
    of the reference's tests."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step)
    api = build_model(cfg32)
    batch = lm_batch(cfg32, GATE_BATCH, GATE_SEQ, seed=2, step=0, device=dev)

    def one_step(accum, remat):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3), accum=accum, remat=remat)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        state = init_train_state(api.init, tcfg, gen, device=dev)
        return make_train_step(api.loss, tcfg)(state, batch)

    (s1, m1), (s2, m2) = one_step(1, None), one_step(2, None)
    d_accum = max(float((a - b).abs().max())
                  for _, a, b in _leaf_pairs(s1["params"], s2["params"]))
    l_accum = abs(float(m1["loss"]) - float(m2["loss"])) / float(m1["loss"])
    if not (d_accum < 1e-5 and l_accum <= 1e-5):
        fail(f"train: accum 2 != accum 1: params {d_accum:.3e} (limit "
             f"1e-5), loss {l_accum:.3e} (limit 1e-5)")
    del s1, s2
    losses = {str(r): float(one_step(1, r)[1]["loss"])
              for r in (None, "full", "dots")}
    l_remat = max(abs(v - losses["None"]) / losses["None"]
                  for v in losses.values())
    if not l_remat <= 1e-6:
        fail(f"train: remat changes the loss: {losses} (limit 1e-6)")
    return {"accum_param_max_err": d_accum, "accum_loss_rel_err": l_accum,
            "remat_losses": losses, "remat_loss_rel_err": l_remat,
            "limits": {"accum_param": 1e-5, "accum_loss_rel": 1e-5,
                       "remat_loss_rel": 1e-6}}


def gate_restart(cfg, dev) -> dict:
    """bf16 compute, int8 AdamW state, at the gate size: 6 steps of
    ``run_resilient`` (checkpoints every 2 steps, async) and again with a
    RuntimeError after step 5; the loss histories and the final states must
    be equal bit for bit, and a checkpoint of the final state (with a bf16
    copy of its parameters) must restore bit for bit. Runs under
    ``torch.use_deterministic_algorithms(True)`` (the embedding backward and
    softmax_xent's gather accumulate with atomics otherwise), restored after
    it. Each run steps through a ``TrainProgram`` of its own (one capture):
    the crash's restore is copied into the captured state."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.fault_tolerance import run_resilient
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                              init_train_state,
                                              make_train_step)
    api = build_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=2, total_steps=16,
                                     state_dtype="int8"),
                       accum=2, remat="full")
    pipe = DataPipeline(cfg, ShapeConfig("gate", GATE_SEQ, GATE_BATCH,
                                         "train"), seed=3, device=dev,
                        prefetch=0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = []
            for tag, fail_at in (("clean", None),
                                 ("crash", {5: RuntimeError("injected")})):
                gen = torch.Generator(device=dev)
                gen.manual_seed(4)
                state = init_train_state(api.init, tcfg, gen, device=dev)
                step_fn = TrainProgram(make_train_step(api.loss, tcfg), dev)
                last = {}

                def step(s, b, step_fn=step_fn, last=last):
                    last["state"], m = step_fn(s, b)
                    return last["state"], m

                mgr = CheckpointManager(os.path.join(tmp, tag), keep=3,
                                        async_save=True)
                rep = run_resilient(step, state, pipe.batch_at, steps=6,
                                    ckpt=mgr, ckpt_every=2, fail_at=fail_at)
                if step_fn.graphs_captured != 1 or last["state"] is not state:
                    fail(f"train: the {tag} run made "
                         f"{step_fn.graphs_captured} captures")
                runs.append((rep, last["state"]))
            (r1, s1), (r2, s2) = runs
            if r2.restarts != 1 or r2.history[:5] != r1.history[:5] or \
                    r2.history[5:] != r1.history[4:]:
                fail(f"train: the restart is not exact: {r1.history} vs "
                     f"{r2.history} ({r2.restarts} restarts)")
            for path, a, b in _leaf_pairs(s1, s2):
                if not _bits_equal(a, b):
                    fail(f"train: the replayed state differs at {path}")
            tree = {"state": s2, "params_bf16": {
                k: v.to(torch.bfloat16) for k, v in
                s2["params"]["blocks"]["attn"].items()}}
            save_checkpoint(os.path.join(tmp, "roundtrip"), 6, tree)
            back, _, _ = restore_checkpoint(os.path.join(tmp, "roundtrip"),
                                            device=dev)
            for path, a, b in _leaf_pairs(tree, back):
                if not _bits_equal(a, b):
                    fail(f"train: checkpoint round trip changed {path}")
    finally:
        torch.use_deterministic_algorithms(was)
    return {"histories": [r1.history, r2.history], "restarts": r2.restarts,
            "history_bitwise_equal": True, "final_state_bitwise_equal": True,
            "roundtrip_bitwise_equal": True,
            "roundtrip_dtypes": sorted({str(b.dtype) for _, _, b in
                                        _leaf_pairs(back, back)})}


def _timed_step(fn) -> float:
    """Host ms of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _median_min_max(ms) -> tuple:
    ms = sorted(ms)
    return ms[len(ms) // 2], [ms[0], ms[-1]]


def phase_train(dev, card) -> dict:
    """Qwen3-0.6B at full width (28 layers, d 1024, vocab 151,936, tied),
    random weights from seed 0, bf16 compute with float32 masters, trained
    8 AdamW steps of 8 x 256 tokens (accum 2, remat "full", float32 state)
    through ``TrainProgram(make_train_step(...))`` fed by
    ``DataPipeline(prefetch=2)``: the first step runs eagerly and captures
    the step, the others replay it. Then 8 eager and 8 replayed steps in
    turns on the same state, timed; the busy share and costliest device
    operations of 2 replayed steps, the busy share and host operations of
    an eager one; and the gates (module docstring). Every gate fails the
    script."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.bench_util import lm_train_bounds
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_loop import (TrainProgram, compute_grads,
                                              init_train_state,
                                              make_train_step)

    kernels.reset_launch_counts()
    cfg = get_config(TRAIN_ARCH)
    api = build_model(cfg)
    tcfg = train_tcfg()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    state = init_train_state(api.init, tcfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = _tree_bytes(state)
    bounds = lm_train_bounds(cfg, state["params"], batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ)
    step_fn = make_train_step(api.loss, tcfg)
    prog = TrainProgram(step_fn, dev)
    pipe = DataPipeline(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"), seed=0, device=dev,
                        prefetch=2)
    losses, step_ms, out = [], [], {}

    def program_step():
        out["state"], out["m"] = prog(state, next(pipe))

    for _ in range(TRAIN_STEPS):
        step_ms.append(_timed_step(program_step))
        if out["state"] is not state:
            fail("train: the program returned another state than the one "
                 "it captured")
        losses.append(float(out["m"]["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over {TRAIN_STEPS} steps: "
             f"{losses}")
    if prog.graphs_captured != 1 or len(prog.buffer_sets) != 1:
        fail(f"train: {prog.graphs_captured} captures, "
             f"{len(prog.buffer_sets)} buffer sets (1 each expected)")

    # eager and replayed steps in turns on the same state (each updates it
    # in place), then the busy share over one of each
    eager_ms, replay_ms = [], []
    for _ in range(TRAIN_STEPS):
        eager_ms.append(_timed_step(lambda: step_fn(state, next(pipe))))
        replay_ms.append(_timed_step(program_step))
    batch = next(pipe)
    busy = _busy_over_steps(lambda: prog(state, batch), n=2)
    busy_eager = _profile_step(lambda: step_fn(state, batch))
    # one more eager step in its two halves, host clock with a synchronise
    # after each: the gradients of both microbatches, then the AdamW update
    batch = next(pipe)
    split = {}
    t0 = time.perf_counter()
    grads, _, _ = compute_grads(api.loss, tcfg, state["params"], batch)
    torch.cuda.synchronize()
    split["grads_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    adamw_update(state["params"], grads, state["opt"], tcfg.opt)
    torch.cuda.synchronize()
    split["optimizer_ms"] = (time.perf_counter() - t0) * 1e3
    pipe.close()
    graph = {"graphs_captured": prog.graphs_captured,
             "capture_s": prog.capture_s,
             "graph_pool_bytes": prog.graph_pool_bytes,
             "capture_step_ms": step_ms[0]}
    del state, out, batch, grads, prog
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, num_layers=GATE_LAYERS, dtype="float32")
    card_cpu = gate_card_vs_cpu(cfg32, dev)
    card_cpu["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    accum_remat = gate_accum_remat(cfg32, dev)
    accum_remat["seconds"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"train: the training path launched an SPE kernel: {launches}")

    med, mm = _median_min_max(replay_ms)
    emed, emm = _median_min_max(eager_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"card": card, "model": cfg.name, "dtype": cfg.dtype,
            "masters": "float32", "params": bounds["params"],
            "layers": cfg.num_layers, "steps": TRAIN_STEPS,
            "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "accum": tcfg.accum, "remat": tcfg.remat,
            "state_dtype": tcfg.opt.state_dtype, "init_s": init_s,
            "losses": losses, "loss_falls": True,
            "program_step_ms_all": step_ms,
            "step_ms": med, "step_ms_min_max": mm, "step_ms_all": replay_ms,
            "eager_step_ms": emed, "eager_step_ms_min_max": emm,
            "eager_step_ms_all": eager_ms,
            "tokens_per_s": tokens / (med / 1e3),
            "eager_tokens_per_s": tokens / (emed / 1e3),
            "step_bound_ms": bounds["step_bound_ms"],
            "step_bound_model_ms": bounds["model_ms"],
            "step_bound_optimizer_ms": bounds["optimizer_ms"],
            "recompute_ms": bounds["recompute_ms"],
            "tokens_per_s_bound": tokens / (bounds["step_bound_ms"] / 1e3),
            "peak_allocated_bytes": peak,
            "peak_above_start_bytes": peak - base_bytes,
            "train_state_bytes": state_bytes, **graph, **busy,
            "eager": busy_eager, "step_split": split,
            "gate_card_vs_cpu": card_cpu, "gate_accum_remat": accum_remat,
            "spe_kernel_launches": launches}


def _train_replay_vs_eager(cfg, dev, batch_at, where: str) -> dict:
    """``cfg``'s step with the train phase's recipe from one initial state:
    1 capturing and TRAIN_STEPS replayed steps of a ``TrainProgram``, in
    turns with as many plain steps from a copy of the state, fed
    ``batch_at(i)``. Every loss and, after the last step, every
    parameter, both moments and ``step`` must be equal bit for bit, with
    one capture. Host ms per step between two synchronisations."""
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (TrainProgram, init_train_state,
                                              make_train_step)
    api = build_model(cfg)
    tcfg = train_tcfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(api.init, tcfg, gen, device=dev)
    eager = _to(state, dev)
    step_fn = make_train_step(api.loss, tcfg)
    prog = TrainProgram(step_fn, dev)
    res, losses, eager_ms, replay_ms = {}, [], [], []
    for i in range(1 + TRAIN_STEPS):
        b = batch_at(i)
        e = _timed_step(lambda: res.update(e=step_fn(eager, b)[1]))
        r = _timed_step(lambda: res.update(r=prog(state, b)))
        got, m = res["r"]
        if got is not state or not _bits_equal(m["loss"], res["e"]["loss"]):
            fail(f"{where}: {cfg.name}: step {i}'s loss {float(m['loss'])} "
                 f"!= eager {float(res['e']['loss'])}")
        losses.append(float(m["loss"]))
        if i:
            eager_ms.append(e)
            replay_ms.append(r)
    n = 0
    for path, x, y in _leaf_pairs(state, eager):
        if not _bits_equal(x, y):
            fail(f"{where}: {cfg.name}: the replayed state differs at {path}")
        n += 1
    if prog.graphs_captured != 1:
        fail(f"{where}: {cfg.name}: {prog.graphs_captured} captures")
    med, mm = _median_min_max(replay_ms)
    emed, emm = _median_min_max(eager_ms)
    return {"replayed_steps": TRAIN_STEPS, "losses": losses,
            "losses_bitwise_equal": True, "state_leaves_bitwise_equal": n,
            "replay_ms_per_step": med, "replay_ms_min_max": mm,
            "eager_ms_per_step": emed, "eager_ms_min_max": emm,
            "graphs_captured": prog.graphs_captured,
            "capture_s": prog.capture_s,
            "graph_pool_bytes": prog.graph_pool_bytes}


def gate_train_replay(cfg, dev) -> dict:
    """The train phase's step at full width (8 x 256 tokens) through
    ``_train_replay_vs_eager``. Needs deterministic algorithms (the
    embedding backward and the gather of ``softmax_xent`` accumulate with
    atomics otherwise)."""
    from repro_torch import kernels
    from repro_torch.data.synthetic import lm_batch
    kernels.reset_launch_counts()
    out = _train_replay_vs_eager(
        cfg, dev, lambda i: lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                     step=i, device=dev), "deterministic")
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"deterministic: an SPE kernel was launched: {launches}")
    return {"model": cfg.name, **out}


TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 4, 32


def phase_train_families(dev) -> dict:
    """Every LM family at ``reduce_config`` size (the serve_families six)
    through ``_train_replay_vs_eager`` on batches of 4 x 32. Runs with
    deterministic algorithms (in ``deterministic_main``)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.synthetic import lm_batch
    kernels.reset_launch_counts()
    out = {}
    for arch, family in SERVE_FAMILIES.items():
        cfg = reduce_config(get_config(arch))
        out[arch] = {"family": family, "dtype": cfg.dtype,
                     "layers": cfg.num_layers, "d_model": cfg.d_model,
                     **_train_replay_vs_eager(
                         cfg, dev, lambda i: lm_batch(
                             cfg, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ,
                             seed=0, step=i, device=dev), "train_families")}
        gc.collect()
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"train_families: an SPE kernel was launched: {launches}")
    return {"families": out, "batch": TRAIN_FAMILY_BATCH,
            "seq_len": TRAIN_FAMILY_SEQ, "accum": 2, "remat": "full",
            "mode": "deterministic algorithms, "
                    "CUBLAS_WORKSPACE_CONFIG=:4096:8",
            "spe_kernel_launches": launches}


def _nccl_world(tmp: str) -> None:
    """An NCCL process group of one rank from a FileStore in ``tmp``: no
    port to collide on, no network."""
    import torch.distributed as dist
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))


def gate_compressed_psum(mesh, dev) -> dict:
    """``compressed_psum`` over the mesh's 'data' dimension (NCCL, one
    rank) equals ``ef_quantize`` of its input bit for bit: the mean is the
    dequantised value, the error the new error."""
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     ef_quantize)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x = torch.randn((1024, 3072), generator=g, device=dev)
    err = torch.randn((1024, 3072), generator=g, device=dev) * 1e-3
    mean, new_err = compressed_psum(x, err, mesh, axis="data")
    deq, ref_err = ef_quantize(x, err)
    if not (_bits_equal(mean, deq) and _bits_equal(new_err, ref_err)):
        fail("distributed: compressed_psum on one rank differs from "
             "ef_quantize")
    return {"shape": list(x.shape), "bitwise_equal": True,
            "quantisation_max_abs_err": float((mean - (x + err)).abs().max())}


def gate_pipeline(dev) -> dict:
    """``make_pipelined_fn`` with one stage and 8 microbatches on a
    ("stage",) mesh equals the stage function applied to each microbatch in
    turn, bit for bit (the hop-free schedule and the final broadcast)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import make_pipelined_fn
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    W = torch.randn((1024, 1024), generator=g, device=dev) / 32
    x = torch.randn((8, 16, 1024), generator=g, device=dev)

    def stage(w, h):
        return torch.tanh(h @ w)

    y = make_pipelined_fn(stage, mesh, n_stages=1, n_microbatches=8)(W, x)
    seq = torch.stack([stage(W, x[i]) for i in range(8)])
    if not _bits_equal(y, seq):
        fail("distributed: the one-stage pipeline differs from the "
             "sequential loop")
    return {"stages": 1, "microbatches": 8, "shape": list(y.shape),
            "bitwise_equal": True}


def dryrun_cell() -> dict:
    """One dry-run cell (qwen3-0.6b, train_4k, pod2x16x16, all 28 layers
    at full width) in a process of its own on the ``fake`` backend, away
    from the card: the launch path's smoke test. Its step runs on one
    rank's meta shards; flops, collective bytes by op and peak bytes are
    counted from the operations that ran, and its terms are modeled from
    the H100 data sheet's peaks, not measurements of the card."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = _dryrun_file(os.path.join(tmp, "dryrun_torch.json"),
                           single_pod=False)
    return {k: rec[k] for k in ("key", "chips", "ran", "bytes_per_rank",
                                "arg_bytes", "temp_bytes",
                                "flops_per_device", "coll_bytes_per_device",
                                "coll_by_op", "compute_s", "memory_s",
                                "collective_s", "dominant", "fits_hbm",
                                "layout_s", "run_s")}


META_COUNT = """
import json, sys, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.analysis.op_costs import OpCounter
from repro_torch.configs import get_config
from repro_torch.distributed.ctx import use_sharding
from repro_torch.distributed.sharding import batch_spec, distribute, param_specs
from repro_torch.models import build_model
from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                          make_train_step)
arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
api = build_model(get_config(arch))
tcfg = TrainConfig(accum=2, remat="full")
st = init_train_state(api.init, tcfg, torch.Generator(), device="meta")
st = distribute(st, mesh, param_specs(mesh, st))
b = {"tokens": torch.zeros((B, S), dtype=torch.int64, device="meta")}
b = distribute(b, mesh, batch_spec(mesh, b))
with use_sharding(mesh), OpCounter() as c:
    c.track(st, b)
    make_train_step(api.loss, tcfg)(st, b)
print("RESULT " + json.dumps(c.costs.to_json()))
"""


def _meta_count() -> dict:
    """The distributed phase's step counted on meta tensors, in a process
    of its own on the ``fake`` backend (world 1, a (1, 1) mesh): the same
    model, recipe (accum 2, remat "full") and batch shape."""
    r = subprocess.run([sys.executable, "-c", META_COUNT, TRAIN_ARCH,
                        str(TRAIN_BATCH), str(TRAIN_SEQ)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC,
                                CUDA_VISIBLE_DEVICES=""))
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode != 0 or not line:
        fail(f"distributed: the meta count failed: {r.stderr[-2000:]}")
    return json.loads(line[-1][len("RESULT "):])


def phase_distributed(dev, card, train) -> dict:
    """The distribution layer on the card at world size 1 (module
    docstring): NCCL gates, then the train phase's full-width Qwen3-0.6B
    step with its state and batches laid out as DTensors by ``param_specs``
    / ``batch_spec`` on the (1, 1) mesh under ``use_sharding``, beside the
    train phase's own numbers, so that DTensor's host cost per step reads
    off; one more step on the card under ``op_costs.OpCounter``, whose
    counted flops must equal the same step's count on meta tensors (the
    dry run's way); then one dry-run cell."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.analysis.op_costs import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step)

    kernels.reset_launch_counts()
    cfg = get_config(TRAIN_ARCH)
    api = build_model(cfg)
    tcfg = train_tcfg()
    with tempfile.TemporaryDirectory() as tmp:
        _nccl_world(tmp)
        try:
            mesh = make_host_mesh(model=1, device="cuda")
            psum = gate_compressed_psum(mesh, dev)
            pipeline = gate_pipeline(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            state = init_train_state(api.init, tcfg, gen, device=dev)
            state = distribute(state, mesh, param_specs(mesh, state))
            pipe = DataPipeline(cfg, ShapeConfig("train", TRAIN_SEQ,
                                                 TRAIN_BATCH, "train"),
                                seed=0, device=dev, prefetch=2)

            def batch():
                b = next(pipe)
                return distribute(b, mesh, batch_spec(mesh, b))

            step_fn = make_train_step(api.loss, tcfg)
            losses, step_ms = [], []
            with use_sharding(mesh):
                for i in range(1 + DIST_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step_fn(state, batch())
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(m["loss"]))
                b = batch()
                busy = _profile_step(lambda: step_fn(state, b))
                peak = torch.cuda.max_memory_allocated()
                b = batch()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with OpCounter() as counter:
                    counter.track(state, b)
                    state, m = step_fn(state, b)
                torch.cuda.synchronize()
                card_peak = torch.cuda.max_memory_allocated() - base
                card_costs = counter.costs.to_json()
            pipe.close()
            kinds = sorted({type(x).__name__ for _, x, _ in
                            _leaf_pairs(state, state)})
            del state, m, b
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or kinds != ["DTensor"]:
        fail(f"distributed: losses {losses}, state leaves {kinds}")
    meta_costs = _meta_count()
    counted = {"card_flops": card_costs["flops"],
               "meta_flops": meta_costs["flops"],
               "card_collective_bytes": card_costs["collective_bytes"],
               "meta_collective_bytes": meta_costs["collective_bytes"],
               "card_counted_peak_bytes": card_costs["peak_bytes"],
               "card_arg_bytes": card_costs["arg_bytes"],
               "card_allocated_peak_over_start_bytes": card_peak,
               "card_ops": card_costs["n_ops"], "meta_ops": meta_costs["n_ops"]}
    print(f"[distributed] counted flops: card {counted['card_flops']:.6e}, "
          f"meta {counted['meta_flops']:.6e}", flush=True)
    if card_costs["flops"] != meta_costs["flops"] or card_costs["flops"] <= 0:
        fail(f"distributed: the card's counted flops differ from the meta "
             f"count: {counted}")
    t0 = time.perf_counter()
    dry = dryrun_cell()
    dry["seconds"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"distributed: the path launched an SPE kernel: {launches}")
    ms = sorted(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = ms[len(ms) // 2]
    return {"card": card, "world": 1, "backend": "nccl",
            "mesh": {"data": 1, "model": 1}, "model": cfg.name,
            "state_leaves": kinds, "gate_compressed_psum": psum,
            "gate_pipeline": pipeline, "warmup_ms": step_ms[0],
            "losses": losses,
            "losses_equal_train_phase": losses == train["losses"][:len(losses)],
            "step_ms": med, "step_ms_min_max": [ms[0], ms[-1]],
            "step_ms_all": step_ms[1:], "tokens_per_s": tokens / (med / 1e3),
            "peak_allocated_bytes": peak, **busy,
            "unsharded_eager": {
                **{k: train[k] for k in ("eager_step_ms",
                                         "eager_step_ms_min_max",
                                         "eager_tokens_per_s",
                                         "peak_allocated_bytes")},
                **{k: train["eager"].get(k) for k in (
                    "device_ops_per_step", "busy_ms")}},
            "dtensor_host_ms_per_step": med - train["eager_step_ms"],
            "op_costs": counted, "dryrun": dry,
            "spe_kernel_launches": launches}


def gate_sharded_equality(cfg, dev) -> dict:
    """The train phase's step (Qwen3-0.6B at full width and depth, bf16 on
    float32 masters, accum 2, remat "full", 8 x 256 tokens), 2 steps from
    one initial state: unsharded, and with state and batches laid out as
    DTensors on a (1, 1) NCCL mesh under ``use_sharding``. The losses and
    the final state (parameters, moments, step) must be equal bit for bit.
    Needs deterministic algorithms (the embedding backward and the gather
    of ``softmax_xent`` accumulate with atomics otherwise)."""
    import torch.distributed as dist
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step)
    api = build_model(cfg)
    tcfg = train_tcfg()
    step_fn = make_train_step(api.loss, tcfg)
    batches = [lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=i,
                        device=dev) for i in range(2)]

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return init_train_state(api.init, tcfg, gen, device=dev)

    ref, ref_losses = fresh(), []
    for b in batches:
        ref, m = step_fn(ref, b)
        ref_losses.append(float(m["loss"]))
    with tempfile.TemporaryDirectory() as tmp:
        _nccl_world(tmp)
        try:
            mesh = make_host_mesh(model=1, device="cuda")
            st = fresh()
            st = distribute(st, mesh, param_specs(mesh, st))
            losses = []
            with use_sharding(mesh):
                for b in batches:
                    st, m = step_fn(st, distribute(b, mesh,
                                                   batch_spec(mesh, b)))
                    losses.append(float(m["loss"]))
            if losses != ref_losses:
                fail(f"deterministic: sharded losses {losses} != unsharded "
                     f"{ref_losses}")
            n = 0
            for path, a, b in _leaf_pairs(ref, st):
                if not _bits_equal(a, b.full_tensor()):
                    fail(f"deterministic: sharded state differs at {path}")
                n += 1
        finally:
            dist.destroy_process_group()
    return {"layers": cfg.num_layers, "steps": 2, "losses": losses,
            "losses_bitwise_equal": True, "state_leaves_bitwise_equal": n}


def deterministic_main() -> None:
    """The gates that need deterministic algorithms, run by ``main`` in a
    process of its own with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS
    held to a fixed workspace from its first handle on), so that no other
    phase runs under it: the restart gate, sharded == unsharded, the train
    phase's replay == eager at full width, and ``train_families``. Prints
    one ``DETERMINISTIC {...}`` line."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        fail("deterministic gates need CUBLAS_WORKSPACE_CONFIG=:4096:8")
    torch.use_deterministic_algorithms(True)
    dev = resolve_device("cuda")
    cfg = get_config(TRAIN_ARCH)
    out = {"cublas_workspace_config": os.environ["CUBLAS_WORKSPACE_CONFIG"]}
    for name, fn, arg in (
            ("gate_restart", gate_restart,
             dataclasses.replace(cfg, num_layers=GATE_LAYERS)),
            ("gate_sharded_equality", gate_sharded_equality, cfg),
            ("gate_train_replay", gate_train_replay, cfg),
            ("train_families", phase_train_families, None)):
        t0 = time.perf_counter()
        out[name] = fn(arg, dev) if arg is not None else fn(dev)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    print("DETERMINISTIC " + json.dumps(out), flush=True)


def phase_deterministic() -> dict:
    """``deterministic_main`` in a subprocess; its failure fails the
    script."""
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--deterministic-gates"],
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("DETERMINISTIC ")]
    if r.returncode != 0 or not lines:
        fail(f"deterministic gates (exit {r.returncode}): "
             f"{r.stderr[-3000:]}")
    return json.loads(lines[-1][len("DETERMINISTIC "):])


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

    ap = argparse.ArgumentParser()
    ap.add_argument("--costs-out", default=None,
                    help="also write the main-path decode-cost table here")
    ap.add_argument("--deterministic-gates", action="store_true",
                    help="run only the deterministic gates (the script "
                         "starts itself so in a subprocess)")
    args = ap.parse_args()
    if args.deterministic_gates:
        deterministic_main()
        return

    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 2)
        return r

    dev = resolve_device("cuda")
    card = timed("device", phase_device)
    clip = timed("kernels_clip", phase_kernels_clip, dev)
    clip_b = timed("kernels_clip_batched", phase_kernels_clip_batched, dev)
    mm = timed("kernels_matmul", phase_kernels_matmul, dev)
    conv = timed("kernels_conv_igemm", phase_kernels_conv_igemm, dev)
    emit("kernels", kernels=[clip, clip_b, mm, conv])
    costs = timed("kernel_costs", phase_kernel_costs, dev, args.costs_out)
    emit("kernel_costs", card=card, **costs["tables"])

    # the main path: every launch counter to 0 just before, read just after
    kernels.reset_launch_counts()
    payload = timed("search", phase_search, dev)
    rows = timed("execute", phase_execute, payload)
    counts = kernels.launch_counts()
    if counts["act_clip_count_batched"] < 21 or counts["act_clip_count"] or \
            counts["block_sparse_matmul"] != 22 or \
            counts["conv_igemm"] != IGEMM_LAYERS * 4:
        fail(f"the main path did not go through the kernels: {counts}")
    emit("search_gates", card=card,
         **timed("search_gates", phase_search_gates, payload))

    factors = costs["main_path_table"]["decode_factors"]
    pat = timed("patterns", phase_patterns, payload, factors)
    emit("patterns", card=card, **pat)
    timing_rows, tot, by = timed("timing", phase_timing, rows)
    emit("timing", card=card, products=timing_rows, totals=tot)
    emit("profile", card=card, **timed("profile", phase_profile, payload,
                                       rows))
    execute_err = max(r["max_abs_err"] for r in rows)
    # the paper phase and the serving slice need none of the search's tensors
    del payload, rows, timing_rows
    gc.collect()
    torch.cuda.empty_cache()
    paper = timed("paper", phase_paper, dev)
    emit("paper", card=card, **paper)
    sess, serve = timed("serve", phase_serve, dev, card)
    emit("serve", **serve)
    emit("fleet", card=card, **timed("fleet", phase_fleet, sess))
    if any(kernels.launch_counts().values()):
        fail(f"fleet: the serving path launched an SPE kernel: "
             f"{kernels.launch_counts()}")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_families",
         **timed("serve_families", phase_serve_families, dev, card))
    twins = timed("bench_twins", phase_bench_twins, dev)
    emit("bench_twins", card=card,
         serve_decode_ms_per_step=serve["decode_ms_per_step"],
         serve_decode_ms_per_step_graph=serve["decode_ms_per_step_graph"],
         **twins)
    gc.collect()
    torch.cuda.empty_cache()
    emit("deploy", **timed("deploy", phase_deploy))
    train = timed("train", phase_train, dev, card)
    emit("train", **train)
    dist_ = timed("distributed", phase_distributed, dev, card, train)
    emit("distributed", **dist_)
    det = timed("deterministic", phase_deterministic)
    families = det.pop("train_families")
    emit("train_families", card=card, **families)
    emit("deterministic", card=card, **det)

    q_launches = twins["quickstart"]["launches"]
    path_launches = {
        # the single entry runs on the quickstart path alone; every stats
        # pass goes through the batched entry
        "act_clip_count": {
            "search+execute": counts["act_clip_count"],
            "quickstart": q_launches["act_clip_count"],
            "bench_twins": twins["spe_kernel_launches"],
            "train": train["spe_kernel_launches"]["act_clip_count"],
            "train_families": families["spe_kernel_launches"][
                "act_clip_count"],
            "distributed": dist_["spe_kernel_launches"]["act_clip_count"]},
        "act_clip_count_batched": {
            "search+execute": counts["act_clip_count_batched"],
            "patterns": pat["launches"]["act_clip_count_batched"],
            "paper": paper["launches"]["act_clip_count_batched"],
            "quickstart": q_launches["act_clip_count_batched"]},
        "block_sparse_matmul": {
            "search+execute": counts["block_sparse_matmul"],
            **{f"kernel_costs_{t}": v["block_sparse_matmul_launches"]
               for t, v in costs["tables"].items()},
            "paper": paper["launches"]["block_sparse_matmul"],
            "quickstart": twins["quickstart"]["launches"][
                "block_sparse_matmul"],
            "bench_twins": twins["spe_kernel_launches"],
            "train": train["spe_kernel_launches"]["block_sparse_matmul"],
            "train_families": families["spe_kernel_launches"][
                "block_sparse_matmul"],
            "distributed": dist_["spe_kernel_launches"][
                "block_sparse_matmul"]},
        # the batched passes of a CNN search, and no LM path
        "conv_igemm": {
            "search+execute": counts["conv_igemm"],
            "patterns": pat["launches"]["conv_igemm"],
            "paper": paper["launches"]["conv_igemm"],
            "quickstart": q_launches["conv_igemm"],
            "bench_twins": twins["spe_kernel_launches"],
            "train": train["spe_kernel_launches"]["conv_igemm"],
            "train_families": families["spe_kernel_launches"][
                "conv_igemm"],
            "distributed": dist_["spe_kernel_launches"]["conv_igemm"]}}
    record = {"kernels": [
        {"name": clip["name"], "route": clip["route"],
         "source": clip["source"], "replaces": clip["replaces"],
         "launches": path_launches["act_clip_count"]["quickstart"],
         "launches_path": "quickstart",
         "max_abs_err": clip["max_abs_err"], "ms": clip["ms"],
         "wrapper_ms": clip["wrapper_ms"], "plain_ms": clip["plain_ms"],
         "plain_device_ms": clip["plain_device_ms"],
         "bound_ms": clip["bound_ms"],
         "bound_by": clip["bound_by"], "library_ms": clip["library_ms"],
         "path_launches": path_launches["act_clip_count"]},
        {"name": clip_b["name"], "route": clip_b["route"],
         "source": clip_b["source"], "replaces": clip_b["replaces"],
         "launches": counts["act_clip_count_batched"],
         "max_abs_err": clip_b["max_abs_err"], "ms": clip_b["ms"],
         "plain_ms": clip_b["plain_ms"],
         "plain_device_ms": clip_b["plain_device_ms"],
         "bound_ms": clip_b["bound_ms"], "bound_by": clip_b["bound_by"],
         "library_ms": clip_b["library_ms"],
         "path_launches": path_launches["act_clip_count_batched"]},
        {"name": mm["name"], "route": mm["route"], "source": mm["source"],
         "replaces": mm["replaces"],
         "launches": counts["block_sparse_matmul"],
         "max_abs_err": max(mm["max_abs_err_f32"], execute_err,
                            paper["max_abs_err"]),
         "ms": tot["ms"], "wrapper_ms": tot["wrapper_ms"],
         "plain_ms": tot["plain_ms"],
         "bound_ms": tot["bound_ms"], "bound_by": by,
         "library_ms": tot["library_ms"],
         "path_launches": path_launches["block_sparse_matmul"]},
        {"name": conv["name"], "route": conv["route"],
         "source": conv["source"], "replaces": conv["replaces"],
         "launches": counts["conv_igemm"],
         "max_abs_err": conv["max_abs_err"], "ms": conv["ms"],
         "wrapper_ms": conv["wrapper_ms"], "plain_ms": conv["plain_ms"],
         "plain_device_ms": conv["plain_device_ms"],
         "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
         "library_ms": conv["library_ms"],
         "path_launches": path_launches["conv_igemm"]},
    ]}
    emit("done", seconds=round(time.perf_counter() - t_start, 1),
         phase_seconds=phase_s)
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
