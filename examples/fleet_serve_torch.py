"""Fleet serving demo of the PyTorch port (DESIGN.md §14): open-loop
continuous batching, autoscale policy search, and a real serve-path replay
— the acts of ``examples/fleet_serve.py`` through ``repro_torch``.

On one seeded bursty trace:

  1. **policy search** — ``autoscale_policy_search`` runs a TPE over the
     fleet controller's knobs (replica schedule bounds, backlog
     thresholds, admission depth, boundary slack), scoring each candidate
     with ``simulate_fleet`` against the trace, and prints the searched
     policy next to every static replica count (host code).
  2. **replay** — the searched fleet's busiest replica stream goes back
     through the *real* open-loop serve path
     (``ServeSession.serve_open_loop``): requests wait for batch slots,
     join the running decode batch at bucket boundaries, and the
     ``ServeReport`` carries per-request queueing/latency like the
     simulator's. On the card the model is the architecture at its
     published width and depth in bf16 (random weights from seed 0); with
     ``--device cpu`` it is the ``reduce_config`` size the JAX demo uses.
     The timing twin (``fleet.open_loop_schedule``) and the real session
     report identical admission/completion clocks.

    PYTHONPATH=src python examples/fleet_serve_torch.py
    PYTHONPATH=src python examples/fleet_serve_torch.py --trace diurnal --device cpu
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
from repro_torch.serve.fleet import open_loop_schedule
from repro_torch.serve.serve_loop import ServeSession, requests_from_trace
from repro_torch.sim import autoscale_policy_search, diurnal_trace, mmpp_trace


def main(argv=None) -> dict:
    """Runs both acts; returns the replay's ``ServeReport`` figures and
    whether its clocks equal the timing twin's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--trace", choices=["mmpp", "diurnal"], default="mmpp")
    ap.add_argument("--requests", type=int, default=4000,
                    help="trace length for the policy search")
    ap.add_argument("--replay-requests", type=int, default=24,
                    help="requests replayed through the real serve path")
    ap.add_argument("--batch-slots", type=int, default=8)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--step-cycles", type=float, default=100.0)
    ap.add_argument("--prefill-cycles", type=float, default=300.0)
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.trace == "mmpp":
        tr = mmpp_trace(args.requests, 2e-4, 1.5e-2, dwell_base=3e5,
                        dwell_burst=8e4, sizes=[8, 16], seed=args.seed)
    else:
        tr = diurnal_trace(args.requests, 2e-5, 1.2e-2, 4e5,
                           sizes=[8, 16], seed=args.seed)
    kw = dict(batch_slots=args.batch_slots, step_cycles=args.step_cycles,
              prefill_cycles=args.prefill_cycles)
    print(f"trace: {tr.kind}, {len(tr)} requests over {tr.span:.3g} cycles "
          f"(offered {tr.offered_load:.3g} tok/cycle)")

    t0 = time.perf_counter()
    pol, rep, base = autoscale_policy_search(
        tr, max_replicas=args.max_replicas, n_trials=args.trials,
        seed=args.seed, **kw)
    dt = time.perf_counter() - t0
    for r in range(1, args.max_replicas + 1):
        p99, cost = base[r]
        tag = " <- best static" if r == base["static_best"] else ""
        print(f"  static R={r}: p99={p99:10.0f}  "
              f"replica-cycles={cost:.3e}{tag}")
    print(f"  searched  : p99={rep.p99:10.0f}  "
          f"replica-cycles={rep.replica_cycles:.3e}  "
          f"(min={pol.min_replicas}, up@{pol.scale_up_backlog:.2g}, "
          f"down@{pol.scale_down_backlog:.2g}, "
          f"boundary={pol.boundary_cycles:.3g} cyc)  [{dt:.1f}s search]")
    p99_s, cost_s = base[base["static_best"]]
    print(f"  win: p99 {rep.p99 / p99_s:.2f}x static at "
          f"{rep.replica_cycles / cost_s:.0%} of the replica-cycles")

    # --- replay the busiest replica's stream through the real serve path
    counts = np.bincount(rep.assignment, minlength=args.max_replicas)
    busiest = int(np.argmax(counts))
    idx = np.flatnonzero(rep.assignment == busiest)[:args.replay_requests]
    sub = tr.__class__(rep.routed_at[idx] - rep.routed_at[idx].min(),
                       tr.sizes[idx], kind=tr.kind)
    cfg = get_config(args.arch)
    if dev.type != "cuda":
        cfg = reduce_config(cfg)
    api = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sess = ServeSession(api, api.init(gen, device=dev),
                        batch_slots=args.batch_slots,
                        S_max=int(8 + max(tr.sizes) + 8), device=dev)
    reqs = requests_from_trace(sub, vocab_size=cfg.vocab_size,
                               prompt_len=8, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    srep = sess.serve_open_loop(reqs, step_cycles=args.step_cycles,
                                prefill_cycles=args.prefill_cycles)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    adm, comp = open_loop_schedule(sub.arrivals, sub.sizes,
                                   batch_slots=args.batch_slots,
                                   step_cycles=args.step_cycles,
                                   prefill_cycles=args.prefill_cycles)
    twin = (np.array_equal(srep.admissions, adm)
            and np.array_equal(srep.completions, comp))
    n_tok = sum(len(o) for o in srep.outputs)
    print(f"replayed replica {busiest}'s first {len(idx)} requests through "
          f"the real open-loop serve path ({cfg.name}, {cfg.num_layers} "
          f"layers x {cfg.d_model}, {cfg.dtype}, {dev}): {n_tok} tokens, "
          f"{srep.prefills} prefills, {srep.decode_steps} decode steps "
          f"in {dt:.1f}s")
    print(f"  virtual clock: p50={srep.p50:.0f} p99={srep.p99:.0f} cycles, "
          f"mean queue wait {srep.queue_wait.mean():.0f} cycles; "
          f"twin-identical={twin}")
    return {"replica": busiest, "requests": len(idx), "tokens": n_tok,
            "prefills": srep.prefills, "decode_steps": srep.decode_steps,
            "p50": srep.p50, "p99": srep.p99, "twin_identical": twin,
            "static_best": base["static_best"], "searched_p99": rep.p99}


if __name__ == "__main__":
    main()
