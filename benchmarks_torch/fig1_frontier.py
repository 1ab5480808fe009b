"""Fig. 1 analogue: the accuracy vs operation-density trade-off frontier
traced by the hardware-aware search (MobileNetV2, the paper's Fig. 1
model)."""
import dataclasses

from benchmarks_torch.common import (calib_images, emit, save_json, target,
                                     timed, trained_cnn)
from repro_torch.configs.paper_cnns import MOBILENETV2
from repro_torch.core.hass import CNNEvaluator, hass_search
from repro_torch.core.perf_model import FPGAModel


def run(iters: int = 16, img_res: int = 64, seed: int = 0, device="cuda",
        out_dir=None):
    dev, out_dir = target(device, out_dir)
    cfg = dataclasses.replace(MOBILENETV2, img_res=img_res)
    params = trained_cnn(cfg, steps=20, device=dev)
    images = calib_images(img_res, seed, device=dev)
    ev = CNNEvaluator(cfg, params, images, FPGAModel(), budget=5261,
                      dse_iters=400, cost_cfg=MOBILENETV2)
    res, us = timed(lambda: hass_search(ev, len(ev.prunable), iters=iters,
                                        hardware_aware=True, seed=seed))
    pts = [{"density": 1.0 - t.metrics["spa"], "acc": t.metrics["acc"],
            "eff": t.metrics["eff"]} for t in res.trials]
    # pareto frontier (max acc per density bucket)
    pareto = []
    for p in sorted(pts, key=lambda p: p["density"]):
        if not pareto or p["acc"] > pareto[-1]["acc"]:
            pareto.append(p)
    save_json("fig1", {"points": pts, "pareto": pareto}, dev, out_dir)
    emit("fig1.frontier", us,
         f"points={len(pts)} best_acc@dens<0.5="
         f"{max((p['acc'] for p in pts if p['density'] < 0.5), default=0):.3f}")
    return pts


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--img-res", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(iters=args.iters, img_res=args.img_res, device=args.device,
        out_dir=args.out_dir)
