"""The paper's main experiment end to end (Fig. 5), as one runner shared by
``examples/hass_search_torch.py`` and ``chip_smoke.py``:

1. ``trained_cnn``     — a short SGD warm-up of a paper CNN on the synthetic
   cluster task, so that magnitude pruning has structure to exploit;
2. ``search_compare``  — ``CNNEvaluator`` + ``hass_search``, hardware-aware
   against software-metrics-only, on the FPGA performance model;
3. ``execute_winner``  — the winning proposal's pruned weights multiplied
   through their static tile schedules by the ``block_sparse_matmul`` kernel.

Everything runs on the card unless the caller passes ``device="cpu"``;
asking for the card on a machine that has none raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core import _dse_ckernel, pruning
from repro_torch.core.hass import CNNEvaluator, SearchResult, hass_search
from repro_torch.core.perf_model import FPGAModel
from repro_torch.data.synthetic import image_batch
from repro_torch.kernels import build, ops, ref
from repro_torch.models import cnn


def resolve_device(device="cuda") -> torch.device:
    """The device to run on. ``"cuda"`` needs a card: there is no silent
    move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the host on purpose")
        # a float32 convolution is TF32 by default on the card; everything
        # here is a float32 result, so both switches are off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def trained_cnn(cfg, steps: int = 30, batch: int = 16, lr: float = 2e-3,
                seed: int = 0, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Lightly train a CNN on the synthetic cluster task so magnitude pruning
    has structure to exploit (no ImageNet at hand). Plain SGD through
    ``torch.autograd`` on the un-clipped forward."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = cnn.init_params(cfg, gen, device=dev)
    paths = [(n, k) for n, p in params.items() for k in p]
    for i in range(steps):
        leaves = [params[n][k].requires_grad_(True) for n, k in paths]
        l, _ = cnn.loss(cfg, params, image_batch(cfg, batch, seed=seed, step=i,
                                                 device=dev))
        grads = torch.autograd.grad(l, leaves)
        with torch.no_grad():
            for (n, k), p, g in zip(paths, leaves, grads):
                params[n][k] = (p - lr * g).detach()
    return params


def dse_backend() -> str:
    """Which engine the batched DSE runs on this machine: the compiled C
    kernel, or its numpy lockstep twin when there is no host compiler."""
    return "c" if _dse_ckernel.get_lib() is not None else "numpy"


def search_compare(iters: int = 16, img_res: int = 224, seed: int = 0,
                   budget: int = 12234, batch_size: Optional[int] = 8,
                   device="cuda", train_steps: int = 20,
                   base_cfg=RESNET18) -> dict:
    """Hardware-aware vs software-metrics-only sparsity search on a paper CNN
    (ResNet-18 by default) at its published widths — computation efficiency
    (throughput / area) of the best design so far, per TPE iteration.
    ``batch_size``: TPE proposals per round; ``None``/0 is the serial
    ask/tell loop. Returns the Fig. 5 payload plus the evaluator and both
    ``SearchResult``s under ``"ev"``, ``"hw_result"``, ``"sw_result"``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(base_cfg, img_res=img_res)
    t0 = time.perf_counter()
    # first-use builds (the CUDA kernels, the compiled DSE kernel) are
    # set-up, not search
    if dev.type == "cuda":
        build.lib()
    backend = dse_backend()
    params = trained_cnn(cfg, steps=train_steps, seed=seed, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    images = torch.randn((8, img_res, img_res, 3), generator=gen).to(dev)
    ev = CNNEvaluator(cfg, params, images, FPGAModel(), budget=budget,
                      dse_iters=600, cost_cfg=base_cfg)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    def go(hardware_aware: bool) -> SearchResult:
        return hass_search(ev, len(ev.prunable), iters=iters,
                           hardware_aware=hardware_aware, seed=seed,
                           batch_size=batch_size or None)

    t0 = time.perf_counter()
    hw_res = go(True)
    sw_res = go(False)
    _sync(dev)
    search_s = time.perf_counter() - t0
    return {
        "iters": iters, "batch_size": batch_size, "img_res": img_res,
        "device": str(dev), "dse_backend": backend,
        "setup_s": setup_s, "search_s": search_s,
        "trials_per_s": 2 * iters / search_s,
        "hw_eff_curve": hw_res.running_best("eff"),
        "sw_eff_curve": sw_res.running_best("eff"),
        "hw_best": hw_res.best_metrics, "sw_best": sw_res.best_metrics,
        "ev": ev, "hw_result": hw_res, "sw_result": sw_res,
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def execute_winner(ev: CNNEvaluator, best_x: np.ndarray, *, max_m: int = 25088,
                   seed: int = 0, keep_operands: bool = False) -> List[dict]:
    """Run the winning proposal through the block-sparse kernel: for every
    prunable layer take the weight in its matmul view ``(k*k*cin, cout)``,
    tile-prune it at the winner's ``s_w`` (whole 128 x 128 tiles, the pattern
    the static schedule can skip), package it as ``SparseWeight``, and
    multiply a seeded ``x`` of the layer's real row count
    ``M = batch * out_hw**2`` (capped at ``max_m``) through the kernel. ``fc``
    is multiplied a second time with the network's real pooled features.
    Every product is held against the plain version (atol = rtol = 1e-4,
    float32 summation order). One row per product."""
    dev = ev.device
    s_w, _ = ev._split(best_x)
    specs = {s.name: s for s in cnn.build_specs(ev.cfg)}
    B = ev.images.shape[0]
    _, outs = cnn.forward(ev.cfg, ev.params, ev.images,
                          return_intermediates=True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    rows = []
    for i, name in enumerate(ev.names):
        s = specs[name]
        w = ev.params[name]["w"]
        w2 = w.reshape(-1, w.shape[-1])
        wp, zero_tiles = pruning.tile_prune(w2, s_w[i])
        sw = ops.SparseWeight(wp)
        M = B if s.kind == "linear" else min(B * s.out_hw ** 2, max_m)
        inputs = [("seeded", torch.randn((M, w2.shape[0]),
                                         generator=gen).to(dev))]
        if name == "fc":
            inputs.append(("gap", outs["gap"]))
        for tag, x in inputs:
            out = sw.matmul(x)
            want = ref.block_sparse_matmul_ref(x, wp, sw.mask, sw.bk, sw.bn)
            err = float((out - want).abs().max())
            ok = bool(torch.allclose(out, want, atol=1e-4, rtol=1e-4)) and \
                bool(torch.isfinite(out).all())
            row = {"layer": name, "x": tag, "M": int(M), "K": int(w2.shape[0]),
                   "N": int(w2.shape[1]), "s_w": float(s_w[i]),
                   "zero_tile_frac": float(zero_tiles),
                   "schedule_steps": sw.steps, "dense_steps": sw.dense_steps,
                   "max_abs_err": err, "ok": ok}
            if keep_operands:
                row["operands"] = (sw, x, wp)
            rows.append(row)
    return rows
