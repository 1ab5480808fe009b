"""End-to-end training with the PyTorch port: ~100M-parameter LM, a
few hundred steps, with gradient accumulation, remat, asynchronous
checkpointing and fault-tolerant resume, on the card unless asked for the
CPU.

Full run:
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
Smoke (the model at ``reduce_config`` size, 8 steps):
    PYTHONPATH=src python examples/train_lm_torch.py --smoke
    PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.perf_model import param_count
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StepWatchdog, run_resilient
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                          init_train_state, make_train_step)

LM100M = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=768, num_heads=12,
    num_kv_heads=4, d_ff=2048, vocab_size=32000, tied_embeddings=True,
    qk_norm=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = LM100M
    if args.smoke:
        from repro_torch.configs import reduce_config
        cfg = reduce_config(cfg)
        args.steps = min(args.steps, 8)

    api = build_model(cfg)
    print(f"model {cfg.name}: ~{param_count(cfg) / 1e6:.0f}M params")
    tcfg = TrainConfig(
        opt=OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps,
                      weight_decay=0.1),
        accum=args.accum, remat="full")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(api.init, tcfg, gen, device=dev)
    # the reference jits the step: one program per shape, captured once as
    # a CUDA graph on the card and replayed every step
    step_fn = TrainProgram(make_train_step(api.loss, tcfg), dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    if args.resume:
        restored = mgr.restore_or_none(device=dev)
        if restored is not None:
            state, step0, _ = restored
            print(f"resumed from step {step0}")

    shape = ShapeConfig("train", args.seq, args.batch * args.accum, "train")
    pipe = DataPipeline(cfg, shape, seed=0, device=dev, prefetch=2)

    t0 = time.time()
    rep = run_resilient(step_fn, state, pipe.batch_at, steps=args.steps,
                        ckpt=mgr, ckpt_every=max(args.steps // 5, 5),
                        watchdog=StepWatchdog())
    dt = time.time() - t0
    toks = args.steps * args.batch * args.accum * args.seq
    print(f"loss {rep.history[0]:.3f} -> {rep.final_loss:.3f} over "
          f"{rep.steps_run} steps | {toks / dt:.0f} tok/s | "
          f"{dt:.0f}s total | restarts={rep.restarts} | "
          f"graphs={step_fn.graphs_captured} ({step_fn.capture_s:.2f}s)")
    assert rep.final_loss < rep.history[0], "training must reduce loss"
    pipe.close()
    return rep


if __name__ == "__main__":
    main()
