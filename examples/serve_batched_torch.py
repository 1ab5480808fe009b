"""Batched serving with the PyTorch port: prefill + decode with KV cache and
continuous batching, on the card unless asked for the CPU.

``--trace poisson|mmpp`` replaces the fixed request list with the request
*mix* of a seeded simulator trace (``repro_torch.sim.trace``): the same
request counts and decode-length buckets the deployment simulator scores.
The replay is closed-loop (back to back).

Without ``--full-width`` the model is the architecture at ``reduce_config``
size; with it, the published widths (random weights from a seed: no weights
are downloaded).

    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
    PYTHONPATH=src python examples/serve_batched_torch.py --full-width
    PYTHONPATH=src python examples/serve_batched_torch.py --trace mmpp --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.serve_loop import ServeSession


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--trace", choices=["poisson", "mmpp"], default=None,
                    help="drive the session from a seeded simulator trace "
                         "instead of a fixed request list")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="the architecture's published widths instead of "
                         "its reduce_config size")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduce_config(cfg)
    api = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init(gen, device=dev)

    sess = ServeSession(api, params, batch_slots=args.batch_slots,
                        S_max=args.prompt_len + args.max_new + 8, device=dev)
    del params                     # the session keeps its own (cast) copy
    frames = None
    if cfg.is_encoder_decoder:
        frames = np.random.default_rng(1).normal(
            size=(args.requests, cfg.num_frames, cfg.d_model)).astype(
                np.float32)
    t0 = time.perf_counter()
    if args.trace:
        from repro_torch.sim.trace import mmpp_trace, poisson_trace
        sizes = ((8, args.max_new), (0.5, 0.5))   # two decode-length buckets
        tr = poisson_trace(args.requests, 1e-5, sizes=sizes, seed=0) \
            if args.trace == "poisson" else \
            mmpp_trace(args.requests, 1e-5, 5e-5, dwell_base=2e6,
                       dwell_burst=5e5, sizes=sizes, seed=0)
        print(f"replaying a {tr.kind} trace: {len(tr)} requests, "
              f"{tr.total_samples} decode tokens")
        if frames is not None:
            raise SystemExit("--trace serves token prompts only; the "
                             "enc-dec family needs frames per request")
        t0 = time.perf_counter()
        outs = sess.replay_trace(tr, vocab_size=cfg.vocab_size,
                                 prompt_len=args.prompt_len)
    else:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
                   for _ in range(args.requests)]
        outs = sess.generate(prompts, max_new=args.max_new, frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        f"the CPU ({torch.get_num_threads()} threads)"
    n_tok = sum(len(o) for o in outs)
    print(f"arch={cfg.name} ({'full width' if args.full_width else 'reduced'}"
          f", {cfg.dtype}) served {args.requests} requests "
          f"({n_tok} new tokens) in {dt:.2f}s -> {n_tok / dt:.1f} tok/s "
          f"on {where}")
    print(f"first completion: {outs[0][:10]}...")
    assert len(outs) == args.requests


if __name__ == "__main__":
    main()
