"""Fig. 5 analogue: hardware-aware vs software-metrics-only sparsity search
on ResNet-18 — computation efficiency (throughput/area) of the best design
so far, per TPE iteration. A thin command line over
``repro_torch.search_run.search_compare``, which is Fig. 5's runner (the
prune + clipped stats forward of every trial on the card, through the
``act_clip_count`` kernel). The paper runs 96 iterations; --iters controls
it."""
from benchmarks_torch.common import emit, save_json, target
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.dse import partition_pipeline
from repro_torch.core.perf_model import TPUModel
from repro_torch.search_run import search_compare


def multi_chip(layers, chips: int) -> dict:
    """The partitioned multi-chip DSE on the modeled TPU (``TPUModel``:
    host arithmetic) over one proposal's sparse layer stack: Fig. 5's
    ``multi_chip`` payload."""
    tpu = TPUModel(chips=chips)
    part = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=chips,
                              batch=256)
    return {
        "chips": chips, "cuts": part.cuts,
        "parts": len(part.cuts) + 1,
        "time_per_batch": part.time_per_batch,
        "imgs_per_s": part.throughput * tpu.freq,
        "steady_imgs_per_s": part.steady_throughput * tpu.freq,
        "dse_calls": part.dse_calls,
    }


def run(iters: int = 16, img_res: int = 64, seed: int = 0,
        budget: int = 12234, batch_size: int = 8, chips: int = 1,
        device="cuda", out_dir=None):
    """``batch_size``: TPE proposals evaluated per round; ``None``/0 falls
    back to the serial ask/tell loop. ``chips > 1`` additionally runs
    ``multi_chip`` on the best hardware-aware proposal's measured
    sparsities."""
    dev, out_dir = target(device, out_dir)
    res = search_compare(iters=iters, img_res=img_res, seed=seed,
                         budget=budget, batch_size=batch_size, device=dev,
                         train_steps=20, base_cfg=RESNET18)
    hw_res, sw_res = res["hw_result"], res["sw_result"]
    payload = {k: res[k] for k in ("iters", "batch_size", "trials_per_s",
                                   "hw_eff_curve", "sw_eff_curve",
                                   "hw_best", "sw_best")}
    if chips and chips > 1:
        payload["multi_chip"] = multi_chip(
            res["ev"].sparse_layers(hw_res.best_x), chips)
    save_json("fig5", payload, dev, out_dir)
    gain = hw_res.best_metrics["eff"] / max(sw_res.best_metrics["eff"], 1e-9)
    emit("fig5.search_compare", res["search_s"] * 1e6,
         f"hw_eff={hw_res.best_metrics['eff']:.1f} "
         f"sw_eff={sw_res.best_metrics['eff']:.1f} gain={gain:.2f}x "
         f"({payload['trials_per_s']:.2f} trials/s @ batch={batch_size})")
    return payload


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=96)
    ap.add_argument("--img-res", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="proposals per evaluation round (0=serial)")
    ap.add_argument("--chips", type=int, default=1,
                    help="modeled TPU chips for the partitioned multi-chip "
                         "DSE (1 = skip)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(iters=args.iters, img_res=args.img_res, batch_size=args.batch_size,
        chips=args.chips, device=args.device, out_dir=args.out_dir)
