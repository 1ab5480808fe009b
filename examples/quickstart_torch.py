"""Quickstart of the PyTorch port: the HASS flow end to end at laptop scale,
the flow of ``examples/quickstart.py`` through ``repro_torch``.

1. build a reduced LM, 2. one-shot magnitude-prune it (§III),
3. run the hardware-aware search (Eq. 6) on a reduced ResNet-18 — every
   stats pass clips and counts each prunable layer's input with the
   ``act_clip_count`` kernel's batched entry,
4. execute a pruned matmul through the ``block_sparse_matmul`` kernel
   (§IV), and clip one activation with ``act_clip_count`` again.

Runs on the card; ``--device cpu`` runs on the host on purpose (the
kernels' plain versions then stand in, and no kernel is launched).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch


def main(argv=None) -> dict:
    """Runs the four acts and returns what they measured: the losses, the
    search's best metrics, the evaluator's prunable layers, stats forwards
    and stats passes (on the card one launch of the clip's batched entry
    per prunable layer per stats pass, and act 4's one of its single
    entry), and act 3's largest differences from ``x @ w`` and from the
    kernel's plain version."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.paper_cnns import RESNET18
    from repro_torch.core import pruning
    from repro_torch.core.hass import CNNEvaluator, hass_search
    from repro_torch.core.perf_model import FPGAModel
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model, cnn

    dev = resolve_device(args.device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)

    # ------------------------------------------------------------ 1+2
    print("== 1/4: build + prune a reduced qwen3 ==")
    cfg = reduce_config(get_config("qwen3-0.6b"))
    api = build_model(cfg)
    params = api.init(gen, device=dev)
    batch = lm_batch(cfg, 4, 32, device=dev)
    with torch.no_grad():
        loss_dense, _ = api.loss(params, batch)
        pruned, achieved = pruning.prune_params(
            params, {"blocks/ffn/w_gate": 0.6, "blocks/ffn/w_up": 0.6})
        loss_sparse, _ = api.loss(pruned, batch)
    print(f"   dense loss {float(loss_dense):.3f} -> 60%-pruned FFN loss "
          f"{float(loss_sparse):.3f}; achieved S_w={list(achieved.values())}")

    # ------------------------------------------------------------ 3
    print("== 2/4: hardware-aware sparsity search (8 TPE iters, Eq. 6) ==")
    ccfg = reduce_config(RESNET18)
    cparams = cnn.init_params(ccfg, gen, device=dev)
    images = torch.randn((8, ccfg.img_res, ccfg.img_res, 3),
                         generator=gen).to(dev)
    ev = CNNEvaluator(ccfg, cparams, images, FPGAModel(), budget=4096,
                      dse_iters=300)
    res = hass_search(ev, len(ev.prunable), iters=8, hardware_aware=True)
    m = res.best_metrics
    print(f"   best: acc={m['acc']:.3f} S̄={m['spa']:.2f} "
          f"thr={m['thr']:.0f} img/s eff={m['eff']:.1f}")

    # ------------------------------------------------------------ 4
    print("== 3/4: block-sparse CUDA kernel on the pruned weight ==")
    w = pruned["blocks"]["ffn"]["w_gate"][0]
    sw = ops.SparseWeight(w)
    x = torch.randn((16, w.shape[0]), generator=gen).to(dev)
    y = sw.matmul(x)
    with torch.no_grad():
        err = float((y - x @ w).abs().max())
        plain = ref.block_sparse_matmul_ref(x, w, sw.mask, sw.bk, sw.bn)
        err_plain = float((y - plain).abs().max())
    print(f"   tile density {sw.tile_density:.2f}, kernel max err {err:.2e} "
          f"(against its plain version {err_plain:.2e})")

    print("== 4/4: activation clipping kernel (dynamic S_a) ==")
    a = torch.randn((64, 256), generator=gen).to(dev)
    y2, zeros = ops.act_clip(a, 0.7)
    n_zero = int(zeros)
    with torch.no_grad():
        clip_ok = bool(torch.equal(y2, ref.act_clip_ref(a, 0.7))) and \
            n_zero == int((y2 == 0).sum())
    print(f"   tau=0.7 zeroed {n_zero}/{a.numel()} "
          f"({n_zero / a.numel():.0%}) — model predicts "
          f"{pruning.act_sparsity_gaussian(0.7):.0%}")
    print("quickstart OK")
    return {"device": str(dev), "loss_dense": float(loss_dense),
            "loss_sparse": float(loss_sparse),
            "best_metrics": dict(m), "prunable": len(ev.prunable),
            "stats_forwards": ev.stats_forwards,
            "stats_passes": ev.stats_passes,
            "tile_density": sw.tile_density, "max_abs_err": err,
            "max_abs_err_plain": err_plain, "clip_zeros": n_zero,
            "clip_equals_plain": clip_ok}


if __name__ == "__main__":
    main()
