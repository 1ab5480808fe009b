"""The paper's main experiment end to end (Fig. 5), as one runner shared by
``examples/hass_search_torch.py`` and ``chip_smoke.py``:

1. ``trained_cnn``     — a short SGD warm-up of a paper CNN on the synthetic
   cluster task, so that magnitude pruning has structure to exploit;
2. ``search_compare``  — ``CNNEvaluator`` + ``hass_search``, hardware-aware
   against software-metrics-only, on the FPGA performance model;
3. ``execute_winner``  — the winning proposal's pruned weights multiplied
   through their static tile schedules by the ``block_sparse_matmul`` kernel;
4. ``pattern_compare`` — the sparsity-pattern axis on the same evaluator,
   priced by the decode factors of ``kernels.kernel_costs``.

Everything runs on the card unless the caller passes ``device="cpu"``;
asking for the card on a machine that has none raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core import _dse_ckernel, pruning
from repro_torch.core.hass import (CNNEvaluator, Lambdas, SearchResult,
                                   hass_search)
from repro_torch.core.perf_model import FPGAModel
from repro_torch.data.synthetic import image_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops, ref
from repro_torch.models import cnn


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms for the block, and its autotuner
    off: on the card a convolution's backward otherwise sums its partial
    weight gradients in an order that changes from call to call, so one
    seed would warm up to other weights on every run. Restores the settings
    it found."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev


def trained_cnn(cfg, steps: int = 30, batch: int = 16, lr: float = 2e-3,
                seed: int = 0, device="cuda", graph: bool = True
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Lightly train a CNN on the synthetic cluster task so magnitude pruning
    has structure to exploit (no ImageNet at hand). Plain SGD through
    ``torch.autograd`` on the un-clipped forward, under
    ``deterministic_convolutions``: one seed gives one set of weights on
    every run on the same card.

    The step is one static-buffer program, as the reference jits it: each
    step's ``image_batch`` (drawn on the CPU) is copied into a static batch
    and the parameters are updated in place, ``p - lr * g``. On the card
    the first step runs eagerly on a side stream and is captured as a CUDA
    graph, which every later step replays; ``graph=False`` runs every step
    eagerly (what the captured warm-up is held against), as the CPU does.
    Returns plain tensors that do not require grad."""
    from repro_torch.kernels.graph import warm_and_capture
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = cnn.init_params(cfg, gen, device=dev)
    # the forward reads aliases that require grad; the update writes the
    # parameters' own storage
    leaves = {n: {k: p.detach().requires_grad_(True) for k, p in d.items()}
              for n, d in params.items()}
    pairs = [(params[n][k], leaves[n][k]) for n in params for k in params[n]]
    data = image_batch(cfg, batch, seed=seed, step=0, device=dev)

    def sgd_step():
        l, _ = cnn.loss(cfg, leaves, data)
        grads = torch.autograd.grad(l, [a for _, a in pairs])
        with torch.no_grad():
            for (p, _), g in zip(pairs, grads):
                p.copy_(p - lr * g)

    captured = None
    with deterministic_convolutions():
        for i in range(steps):
            if i:
                for k, v in image_batch(cfg, batch, seed=seed, step=i,
                                        device="cpu").items():
                    data[k].copy_(v)
            if captured is not None:
                captured.replay()
            elif graph and dev.type == "cuda":
                captured = warm_and_capture(sgd_step, None, dev)[0]
            else:
                sgd_step()
    return params


def calib_images(img_res: int, seed: int = 0, n: int = 8,
                 device="cuda") -> torch.Tensor:
    """``n`` seeded N(0, 1) calibration images, NHWC, drawn on the CPU so
    that one seed gives one batch on every device (the JAX package draws
    its own from ``jax.random``, whose stream torch cannot reproduce)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randn((n, img_res, img_res, 3), generator=gen).to(device)


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
    ask/tell loop. Returns the Fig. 5 payload (``setup_s`` holds the SGD
    warm-up's ``warmup_s``) plus the evaluator and both ``SearchResult``s
    under ``"ev"``, ``"hw_result"``, ``"sw_result"``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(base_cfg, img_res=img_res)
    t0 = time.perf_counter()
    # first-use builds (the CUDA kernels, the compiled DSE kernel) are
    # set-up, not search
    if dev.type == "cuda":
        build.lib()
    backend = dse_backend()
    t1 = time.perf_counter()
    params = trained_cnn(cfg, steps=train_steps, seed=seed, device=dev)
    _sync(dev)
    warmup_s = time.perf_counter() - t1
    images = calib_images(img_res, seed, device=dev)
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
        "setup_s": setup_s, "warmup_s": warmup_s, "search_s": search_s,
        "trials_per_s": 2 * iters / search_s,
        "hw_eff_curve": hw_res.running_best("eff"),
        "sw_eff_curve": sw_res.running_best("eff"),
        "hw_best": hw_res.best_metrics, "sw_best": sw_res.best_metrics,
        "ev": ev, "hw_result": hw_res, "sw_result": sw_res,
    }


def pattern_compare(ev: CNNEvaluator, pattern_costs: Dict[str, float], *,
                    iters: int = 16, seed: int = 0,
                    batch_size: Optional[int] = 8,
                    meas: float = 0.05) -> dict:
    """The sparsity-pattern axis (DESIGN.md §16) on ``ev``'s network,
    calibration batch and hardware model, in two hardware-aware searches:

    * ``unstructured`` — the degenerate axis ``patterns=("unstructured",)``,
      which must replay a ``patterns=None`` search trial for trial;
    * ``patterns`` — every pattern of ``pruning.PATTERNS`` as one categorical
      variable per prunable layer, priced by the decode factors
      ``pattern_costs`` (``kernels.kernel_costs.decode_factors``) in Eq. 1
      and, with weight ``meas``, in Eq. 6.

    Each arm has its own evaluator (``dataclasses.replace`` of ``ev``)."""
    L = len(ev.prunable)
    out: dict = {}
    for arm, kw, lam in (
            ("unstructured", dict(patterns=("unstructured",)), None),
            ("patterns", dict(patterns=pruning.PATTERNS,
                              pattern_costs=dict(pattern_costs)),
             Lambdas(meas=meas))):
        pev = dataclasses.replace(ev, **kw)
        t0 = time.perf_counter()
        res = hass_search(pev, L, iters=iters, seed=seed, lambdas=lam,
                          batch_size=batch_size or None)
        _sync(pev.device)
        dt = time.perf_counter() - t0
        out[arm] = {"ev": pev, "result": res, "trials_per_s": iters / dt}
    pev, res = out["patterns"]["ev"], out["patterns"]["result"]
    codes = pev._pattern_codes(res.best_x)
    out["best_assignment"] = [
        {"layer": n, "pattern": pev.patterns[int(c)], "s_w": float(s)}
        for n, c, s in zip(pev.names, codes, pev._split(res.best_x)[0])]
    return out


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
    is multiplied a second time with its real input from the dense forward,
    tagged with the layer that made it (``gap``: the pooled features; on
    MobileNetV3, ``fc2``).
    Every product is held against the plain version (atol = rtol = 1e-4,
    float32 summation order). One row per product."""
    dev = ev.device
    s_w, _ = ev._split(best_x)
    order = cnn.build_specs(ev.cfg)
    specs = {s.name: s for s in order}
    # the layer whose output fc reads
    fc_in = next(s.input_from or prev.name
                 for prev, s in zip(order, order[1:]) if s.name == "fc")
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
            inputs.append((fc_in, outs[fc_in]))
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
