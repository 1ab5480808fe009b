"""Fig. 6 analogue: dense -> sparse modeled speedup per model, at matched
resource budgets (the benefit of exploiting both weight and activation
sparsity in the dataflow pipeline). Host only: the payload equals the JAX
package's."""
import dataclasses

from benchmarks_torch.common import emit, save_json, target, timed
from repro_torch.configs.paper_cnns import PAPER_CNNS
from repro_torch.core.dse import incremental_dse
from repro_torch.core.perf_model import FPGAModel, cnn_layer_costs

BUDGETS = {"resnet18": 12234, "resnet50": 7434, "mobilenetv2": 5261,
           "mobilenetv3s": 1796, "mobilenetv3l": 4324}


def run(s_w: float = 0.6, s_a: float = 0.4, seed: int = 0, device="cuda",
        out_dir=None):
    dev, out_dir = target(device, out_dir)
    hw = FPGAModel()
    out = {}
    for cfg in PAPER_CNNS:
        layers = cnn_layer_costs(cfg)
        sparse = [dataclasses.replace(l, s_w=s_w if l.prunable else 0.0,
                                      s_a=s_a if l.prunable else 0.0)
                  for l in layers]
        budget = BUDGETS[cfg.name]

        def both():
            d = incremental_dse(layers, hw, budget, max_iters=2500)
            s = incremental_dse(sparse, hw, budget, max_iters=2500)
            return d, s
        (dense, spr), us = timed(both)
        speedup = spr.throughput / max(dense.throughput, 1e-18)
        out[cfg.name] = {
            "dense_images_s": dense.throughput * hw.freq,
            "sparse_images_s": spr.throughput * hw.freq,
            "speedup": speedup,
        }
        emit(f"fig6.{cfg.name}", us, f"speedup={speedup:.2f}x "
             f"dense={dense.throughput * hw.freq:.0f} "
             f"sparse={spr.throughput * hw.freq:.0f} img/s")
    save_json("fig6", out, dev, out_dir)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(device=args.device, out_dir=args.out_dir)
