"""Device time of each convolution of the evaluator's batched pass that the
implicit-GEMM kernel takes (``cnn.is_igemm``: the 3 x 3s, the strided
1 x 1 projections, the stems), both ways, on one card: ResNet-18's,
ResNet-50's and MobileNetV3-L's layers at 224 x 224, B = 8 proposals of
N = 8 images, float32 with TF32 off (the evaluator's
``_float32_convolutions``).

* ``cudnn``: the layer as ``forward_batched`` ran it before the kernel
  (the kernel's plain version, ``kernels.ref.conv_igemm_ref``): the HWIO
  copy of the B pruned weights, one grouped convolution (cuDNN's engine,
  with whatever layout transposes it makes), the bias repeated B times
  and added, the relu;
* ``igemm``: ``ops.conv_igemm`` on the same tensors, one launch with the
  bias and relu in its epilogue.

MobileNetV3-L's stem (hswish) adds the activation after either. Each is
captured ``--reps`` times into one CUDA graph and its replays timed with
CUDA events (device time without host gaps), beside the layer's bound:
its flops (2 per MAC) at 67 TFLOP/s or its bytes (x, w and y once) at
3.35 TB/s, whichever is longer. Layers of one shape are timed once and
counted by their number. Then, for each distinct shape, the device
operations one call of each route makes (``torch.profiler``), by name and
device time, and the largest gap between the two routes' outputs (0
where the kernel sums in cuDNN's order, as it should).

    python3 tools/conv_igemm_torch.py [--reps 20] [--out FILE]   # needs one CUDA device

Prints one JSON object (and writes it to ``--out``).
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = ("resnet18", "resnet50", "mobilenetv3l")
B, N = 8, 8


def shapes(cnn, get_config):
    """arch -> [(cin, cout, k, stride, in_hw, act, layers of that shape)]
    in first-seen order."""
    out = {}
    for arch in ARCHS:
        seen = {}
        for s in cnn.build_specs(get_config(arch)):
            if cnn.is_igemm(s, B):
                key = (s.cin, s.cout, s.k, s.stride, s.in_hw, s.act)
                seen[key] = seen.get(key, 0) + 1
        out[arch] = [k + (n,) for k, n in seen.items()]
    return out


def _card(torch, dev) -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return q.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def _routes(torch, cnn, kernels, cin, cout, k, stride, hw, act, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(cin * 7919 + cout * 31 + k)
    x = torch.randn((N, hw, hw, B * cin), generator=gen, device=dev)
    # the pruned weights as the evaluator stacks them: (B, k, k, cin, cout)
    w = torch.randn((B, k, k, cin, cout), generator=gen,
                    device=dev) / (k * cin ** 0.5)
    b = torch.randn((cout,), generator=gen, device=dev) / 4
    relu, pad = act == "relu", (k - 1) // 2

    def cudnn():
        return cnn._act(kernels.ref.conv_igemm_ref(x, w, b, stride, relu, pad),
                        "none" if relu else act)

    def igemm():
        return cnn._act(kernels.ops.conv_igemm(x, w, b, stride, relu, pad),
                        "none" if relu else act)
    return {"cudnn": cudnn, "igemm": igemm}


def _graph_ms(torch, fn, reps, dev) -> float:
    """Device ms of one call: ``reps`` calls captured in one graph, the
    median of 5 timed replays after a warm one."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    times = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del g
    return sorted(times)[2]


def _kernels(torch, fn):
    """(name, device us) of each device operation one call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, round(e.time_range.elapsed_us(), 3))
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and
            not getattr(e, "is_user_annotation", False)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("conv_igemm_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from hassbench import yardstick
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.hass import _float32_convolutions
    from repro_torch.kernels import conv_igemm
    from repro_torch.models import cnn
    dev = torch.device("cuda")
    out = {"card": _card(torch, dev), "B": B, "N": N, "reps": a.reps,
           "torch": torch.__version__, "layers": {}, "totals_ms": {},
           "kernels": {}, "slower": []}
    with torch.no_grad(), _float32_convolutions():
        for arch, rows_of in shapes(cnn, get_config).items():
            rows = []
            tot = {"cudnn": 0.0, "igemm": 0.0, "bound": 0.0, "layers": 0}
            for cin, cout, k, stride, hw, act, n in rows_of:
                fns = _routes(torch, cnn, kernels, cin, cout, k, stride, hw,
                              act, dev)
                ho = conv_igemm.out_size(hw, k, stride, (k - 1) // 2)
                M = N * ho * ho
                flops = 2.0 * M * B * k * k * cin * cout
                nbytes = 4.0 * B * (N * hw * hw * cin + k * k * cin * cout
                                    + M * cout)
                bound = 1e3 * max(flops / yardstick.FP32_FLOPS,
                                  nbytes / yardstick.HBM_BYTES_PER_S)
                row = {"cin": cin, "cout": cout, "k": k, "stride": stride,
                       "hw": hw, "act": act, "M": M, "layers": n,
                       "tile_m": conv_igemm.tile_m(
                           M, cout, B, conv_igemm.sm_count(dev)),
                       "gflop": flops / 1e9, "bound_ms": bound}
                for name, fn in fns.items():
                    row[f"{name}_ms"] = _graph_ms(torch, fn, a.reps, dev)
                    tot[name] += n * row[f"{name}_ms"]
                tot["bound"] += n * bound
                tot["layers"] += n
                y0, y1 = fns["cudnn"](), fns["igemm"]()
                row["max_abs_gap"] = (y0 - y1).abs().max().item()
                row["max_abs"] = y0.abs().max().item()
                row["igemm_roofline_pct"] = 100.0 * bound / row["igemm_ms"]
                row["speedup"] = row["cudnn_ms"] / row["igemm_ms"]
                key = f"{arch}:{cin}x{cout}k{k}s{stride}@{hw}"
                if row["igemm_ms"] > row["cudnn_ms"]:
                    out["slower"].append(key)
                out["kernels"][key] = {name: _kernels(torch, fn)
                                       for name, fn in fns.items()}
                rows.append(row)
                print(json.dumps({"arch": arch, **row}), file=sys.stderr)
            tot["igemm_roofline_pct"] = 100.0 * tot["bound"] / tot["igemm"]
            tot["cudnn_roofline_pct"] = 100.0 * tot["bound"] / tot["cudnn"]
            tot["speedup"] = tot["cudnn"] / tot["igemm"]
            out["layers"][arch] = rows
            out["totals_ms"][arch] = tot
    line = json.dumps(out, sort_keys=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({"totals_ms": out["totals_ms"], "card": out["card"],
                      "slower": out["slower"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
