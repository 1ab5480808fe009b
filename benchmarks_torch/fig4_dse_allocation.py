"""Fig. 4 analogue: per-layer (SPE count, MAC/SPE) allocation for a sparse
ResNet-18 workload — higher sparsity -> fewer MACs per SPE; later layers
(more filters) -> more parallel SPEs to hold the pipeline rate. Host only
(the DSE over ``cnn_layer_costs``): the payload equals the JAX package's."""
import dataclasses

import numpy as np

from benchmarks_torch.common import emit, save_json, target, timed
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.dse import incremental_dse, incremental_dse_ref
from repro_torch.core.perf_model import FPGAModel, cnn_layer_costs


def run(budget: int = 12234, seed: int = 0, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    hw = FPGAModel()
    rng = np.random.default_rng(seed)
    layers = []
    # the paper's Fig. 4 workload: 16 3x3 convs with per-layer sparsity stats
    for l in cnn_layer_costs(RESNET18):
        if l.kind == "conv" and l.m_dot % 9 == 0 and l.name != "stem" \
                and "proj" not in l.name:
            s_w = float(rng.uniform(0.3, 0.8))
            s_a = float(rng.uniform(0.2, 0.6))
            layers.append(dataclasses.replace(l, s_w=s_w, s_a=s_a))
    (res,), us = timed(lambda: (incremental_dse(layers, hw, budget,
                                                max_iters=4000),))
    # the scalar reference must agree exactly
    ref, us_ref = timed(lambda: incremental_dse_ref(layers, hw, budget,
                                                    max_iters=4000))
    assert ref.designs == res.designs and ref.throughput == res.throughput
    table = []
    for l, d in zip(layers, res.designs):
        table.append({"layer": l.name, "s_pair": round(l.s_pair, 3),
                      "spe": d.spe, "mac_per_spe": d.macs_per_spe,
                      "dsp": d.spe * d.macs_per_spe})
        print(f"  {l.name:10s} S̄={l.s_pair:.2f} SPE={d.spe:5d} "
              f"N={d.macs_per_spe:4d}")
    # the full non-dominated (resource, throughput) frontier of the search
    f = res.frontier
    frontier = [{"res": float(r), "thr": float(t),
                 "imgs_per_s": float(t) * hw.freq}
                for r, t in zip(f.res, f.thr)]
    print(f"  frontier: {len(f)} non-dominated points, "
          f"res [{f.res[0]:.0f}, {f.res[-1]:.0f}] DSP -> "
          f"thr [{f.thr[0] * hw.freq:.1f}, {f.thr[-1] * hw.freq:.1f}] img/s")
    save_json("fig4", {"rows": table, "throughput": res.throughput,
                       "resource": res.resource, "frontier": frontier},
              dev, out_dir)
    emit("fig4.dse_allocation", us,
         f"layers={len(layers)} thr={res.throughput * hw.freq:.0f}img/s "
         f"res={res.resource:.0f} vec_speedup={us_ref / max(us, 1e-9):.1f}x")
    return table


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(device=args.device, out_dir=args.out_dir)
