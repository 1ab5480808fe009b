"""Table II analogue: dense vs HASS-sparse designs for the paper's models.

For each CNN (ResNet-18/50, MobileNetV2, MobileNetV3-S/L):
  * dense DSE -> modeled throughput + resource (the 'Dense' columns),
  * short HASS search -> sparse design (the 'Ours' columns),
  * report throughput (samples/s), resource units, efficiency
    (samples/cycle/DSP x 1e9 — the paper's images/cycle/DSP) and the
    sparse/dense efficiency ratio (paper: 1.3-4.2x).
The accuracy proxy and the measured sparsities come from forwards at
``img_res`` (on the card every prunable layer's clip and zero count is one
launch of the ``act_clip_count`` kernel's batched entry per stats pass);
C_l and the DSE use the full 224 x 224 layer costs (analytic — no forward
needed). ``row`` is one model's work, shared with ``chip_smoke.py``'s
``paper`` phase.
"""
import dataclasses

from benchmarks_torch.common import (calib_images, emit, save_json, target,
                                     timed, trained_cnn)
from repro_torch.configs.paper_cnns import PAPER_CNNS
from repro_torch.core.dse import incremental_dse
from repro_torch.core.hass import CNNEvaluator, hass_search
from repro_torch.core.perf_model import FPGAModel

BUDGETS = {"resnet18": 12234, "resnet50": 7434, "mobilenetv2": 5261,
           "mobilenetv3s": 1796, "mobilenetv3l": 4324}     # Table II (Ours)


def row(cfg, params, images, budget, iters, *, cost_cfg=None, seed: int = 0):
    """One model's Table II row: the dense DSE, then a hardware-aware
    ``hass_search`` of ``iters`` trials on ``CNNEvaluator(cfg, params,
    images)`` (``cost_cfg``: the full-resolution config for C_l).
    Returns ``(row, evaluator, SearchResult)``."""
    hw = FPGAModel()
    ev = CNNEvaluator(cfg, params, images, hw, budget=budget,
                      dse_iters=800, cost_cfg=cost_cfg or cfg)
    dense = incremental_dse(ev.layers, hw, budget, max_iters=2500)
    dense_thr = dense.throughput * hw.freq
    dense_eff = dense.throughput / max(dense.resource, 1e-9) * 1e9

    def search():
        return hass_search(ev, len(ev.prunable), iters=iters,
                           hardware_aware=True, seed=seed)
    res, us = timed(search)
    m = res.best_metrics
    eff = m["thr"] / hw.freq / max(m["dsp"] * budget, 1e-9) * 1e9
    out = {
        "dense_images_s": dense_thr, "dense_res": dense.resource,
        "dense_eff_e9": dense_eff,
        "sparse_images_s": m["thr"], "sparse_res": m["dsp"] * budget,
        "sparse_eff_e9": eff, "acc_proxy": m["acc"], "spa": m["spa"],
        "eff_ratio": eff / max(dense_eff, 1e-12),
        "search_s": us / 1e6,
    }
    return out, ev, res


def run(iters: int = 12, img_res: int = 64, seed: int = 0, device="cuda",
        out_dir=None):
    dev, out_dir = target(device, out_dir)
    rows = {}
    for cfg in PAPER_CNNS:
        small = dataclasses.replace(cfg, img_res=img_res)
        params = trained_cnn(small, steps=20, device=dev)
        images = calib_images(img_res, seed, device=dev)
        r, _, _ = row(small, params, images, BUDGETS[cfg.name], iters,
                      cost_cfg=cfg, seed=seed)
        rows[cfg.name] = r
        emit(f"table2.{cfg.name}", r["search_s"] * 1e6,
             f"eff_ratio={r['eff_ratio']:.2f}x "
             f"acc={r['acc_proxy']:.3f} thr={r['sparse_images_s']:.0f}img/s")
    save_json("table2", rows, dev, out_dir)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--img-res", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(iters=args.iters, img_res=args.img_res, device=args.device,
        out_dir=args.out_dir)
