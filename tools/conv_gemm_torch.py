"""Device time of each 1 x 1 stride-1 convolution of the evaluator's batched
pass, both ways, on one card: ResNet-50's and MobileNetV3-L's layers at
224 x 224, B = 8 proposals of N = 8 images, float32 with TF32 off (the
evaluator's ``_float32_convolutions``).

* ``cudnn``: the layer as ``forward_batched`` runs a grouped convolution:
  the HWIO copy of the B pruned weights, then ``cnn._conv`` (cuDNN's
  engine, with whatever layout transposes and weight copy it makes);
* ``gemm``: ``cnn._conv_gemm`` on the same tensors, one strided-batched
  product on the NHWC activations.

Each is captured ``--reps`` times into one CUDA graph and its replays timed
with CUDA events (device time without host gaps), beside the layer's bound:
its flops at 67 TFLOP/s or its bytes (x and w read once, y written once)
at 3.35 TB/s, whichever is longer. Layers of one shape are timed once and
counted by their number. Then, for each distinct shape, the kernels one
call of each route launches (``torch.profiler``), by name and device time,
and the largest gap between the two routes' outputs: over the B groups
(``max_abs_gap``), and over the first group alone (``one_group_gap``: the
product of one proposal against its convolution, the route that
``cnn.is_gemm`` keeps for one group).

    python3 tools/conv_gemm_torch.py [--reps 20] [--out FILE]   # needs one CUDA device

Prints one JSON object (and writes it to ``--out``).
"""
import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = ("resnet50", "mobilenetv3l")
B, N = 8, 8


def _shapes(cnn, get_config):
    """arch -> [(cin, cout, hw, layers of that shape)] in first-seen order."""
    out = {}
    for arch in ARCHS:
        seen = {}
        for s in cnn.build_specs(get_config(arch)):
            if cnn.is_gemm(s, B):
                key = (s.cin, s.cout, s.out_hw)
                seen[key] = seen.get(key, 0) + 1
        out[arch] = [k + (n,) for k, n in seen.items()]
    return out


def _routes(torch, cnn, cin, cout, hw, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(cin * 7919 + cout)
    x = torch.randn((N, hw, hw, B * cin), generator=gen, device=dev)
    # the pruned weights as the evaluator stacks them: (B, 1, 1, cin, cout)
    w = torch.randn((B, 1, 1, cin, cout), generator=gen,
                    device=dev) / cin ** 0.5

    def cudnn():
        hwio = w.permute(1, 2, 3, 0, 4).reshape(1, 1, cin, B * cout)
        return cnn._conv(x, hwio, 1, 0, B)

    def gemm():
        return cnn._conv_gemm(x, w.reshape(B, cin, cout))

    def one_group_gap():
        x1 = x[..., :cin].contiguous()
        y = cnn._conv(x1, w[0], 1, 0, 1)
        return (y - cnn._conv_gemm(x1, w[0].reshape(1, cin, cout))
                ).abs().max().item()
    return {"cudnn": cudnn, "gemm": gemm}, one_group_gap


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
        print("conv_gemm_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from hassbench import yardstick
    from repro_torch.configs import get_config
    from repro_torch.core.hass import _float32_convolutions
    from repro_torch.models import cnn
    dev = torch.device("cuda")
    out = {"card": torch.cuda.get_device_name(dev), "B": B, "N": N,
           "reps": a.reps, "torch": torch.__version__, "layers": {},
           "totals_ms": {}, "kernels": {}}
    with torch.no_grad(), _float32_convolutions():
        for arch, shapes in _shapes(cnn, get_config).items():
            rows, tot = [], {"cudnn": 0.0, "gemm": 0.0, "bound": 0.0}
            for cin, cout, hw, n in shapes:
                fns, one_group_gap = _routes(torch, cnn, cin, cout, hw,
                                             dev)
                M = N * hw * hw
                flops = 2.0 * M * B * cin * cout
                nbytes = 4.0 * B * (M * cin + cin * cout + M * cout)
                bound = 1e3 * max(flops / yardstick.FP32_FLOPS,
                                  nbytes / yardstick.HBM_BYTES_PER_S)
                row = {"cin": cin, "cout": cout, "hw": hw, "M": M,
                       "layers": n, "bound_ms": bound}
                for name, fn in fns.items():
                    row[f"{name}_ms"] = _graph_ms(torch, fn, a.reps, dev)
                    tot[name] += n * row[f"{name}_ms"]
                tot["bound"] += n * bound
                y0, y1 = fns["cudnn"](), fns["gemm"]()
                row["max_abs_gap"] = (y0 - y1).abs().max().item()
                row["max_abs"] = y0.abs().max().item()
                row["one_group_gap"] = one_group_gap()
                row["gemm_roofline_pct"] = 100.0 * bound / row["gemm_ms"]
                row["speedup"] = row["cudnn_ms"] / row["gemm_ms"]
                key = f"{arch}:{cin}x{cout}@{hw}"
                out["kernels"][key] = {k: _kernels(torch, fn)
                                       for k, fn in fns.items()}
                rows.append(row)
                print(json.dumps({"arch": arch, **row}), file=sys.stderr)
            out["layers"][arch] = rows
            out["totals_ms"][arch] = tot
    line = json.dumps(out, sort_keys=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({"totals_ms": out["totals_ms"], "card": out["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
