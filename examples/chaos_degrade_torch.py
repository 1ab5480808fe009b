"""Chaos & graceful-degradation demo of the PyTorch port (DESIGN.md §17):
fault-injected fleet serving, frontier-priced degradation, and
failure-aware search — the acts of ``examples/chaos_degrade.py`` through
``repro_torch``.

Four acts on one seeded bursty trace with one replica lost at the peak:

  1. **crash** — ``simulate_fleet`` replays the trace under a
     ``replica_loss`` fault: in-flight requests on the crashed replica
     re-enqueue with retry backoff, deadline-bound stragglers shed, and
     the report accounts every request (completed or shed, never lost).
  2. **degrade** — a ``DegradationPolicy`` ladder priced off the DSE
     frontier (``core.dse.degradation_ladder``: extra sparsity -> faster
     decode steps) lets the fleet trade accuracy for throughput during
     the outage; the degraded run sheds strictly fewer requests at no
     extra replica cost.
  3. **search** — ``autoscale_policy_search`` run fault-blind vs
     failure-aware (trials simulated under the fault set): the aware
     winner survives the crash with a lower tail.
  4. **replay** — the degraded rung schedule goes through the *real*
     open-loop serve path; the timing twin and the real session report
     identical clocks. On the card the model is the architecture at its
     published width and depth in bf16 (random weights from seed 0); with
     ``--device cpu`` it is the ``reduce_config`` size the JAX demo uses.

Acts 1–3 are host code (the fleet simulator and the DSE are numpy).

    PYTHONPATH=src python examples/chaos_degrade_torch.py
    PYTHONPATH=src python examples/chaos_degrade_torch.py --deadline 3e5 --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main(argv=None) -> dict:
    """Runs the four acts; returns each act's figures (the replay's clocks
    against the timing twin's under ``"replay"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=1500)
    ap.add_argument("--deadline", type=float, default=2e5,
                    help="per-request deadline in cycles past arrival")
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--replay-requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)

    from repro_torch.configs.paper_cnns import RESNET18
    from repro_torch.core.dse import degradation_ladder
    from repro_torch.core.perf_model import FPGAModel
    from repro_torch.serve.fleet import (AutoscalePolicy, DegradationPolicy,
                                         open_loop_schedule, simulate_fleet)
    from repro_torch.sim import (autoscale_policy_search, mmpp_trace,
                                 replica_loss)

    kw = dict(batch_slots=8, step_cycles=100.0, prefill_cycles=300.0)
    tr = mmpp_trace(args.requests, 2e-4, 2e-2, dwell_base=2e5,
                    dwell_burst=1.5e5, sizes=[8, 16], seed=args.seed)
    peak = float(np.median(tr.arrivals))
    ft = replica_loss(1, peak, peak + 2e6)
    print(f"trace: {len(tr)} requests over {tr.span:.3g} cycles; replica 1 "
          f"lost at t={peak:.3g} for 2e6 cycles; deadline "
          f"{args.deadline:.3g} cycles")

    # --- 1: the crash, hard-shedding fleet
    plain = simulate_fleet(tr, AutoscalePolicy.static(2), faults=ft,
                           deadline_cycles=args.deadline, **kw)
    print(f"  crash:    shed={plain.shed:4d}  retries={plain.retries.sum()}"
          f"  p99={plain.p99:.3e}  cost={plain.replica_cycles:.3e}")

    # --- 2: the same crash with a frontier-priced degradation ladder
    rungs = degradation_ladder(
        _sparse_stack(RESNET18, args.seed), FPGAModel(), budget=4096.0,
        s_extra=(0.0, 0.2, 0.4))
    ladder = tuple(r.step_scale for r in rungs)
    deg = DegradationPolicy(ladder=ladder, degrade_backlog=3.0,
                            recover_backlog=0.5, dwell_cycles=1e5,
                            switch_cycles=1e4)
    soft = simulate_fleet(tr, AutoscalePolicy.static(2), faults=ft,
                          deadline_cycles=args.deadline, degradation=deg,
                          **kw)
    print(f"  degrade:  shed={soft.shed:4d}  "
          f"ladder={tuple(round(s, 3) for s in ladder)}  "
          f"rung moves={len(soft.rung_timeline) - 1}  "
          f"p99={soft.p99:.3e}  cost={soft.replica_cycles:.3e}")

    # --- 3: fault-blind vs failure-aware policy search
    t0 = time.perf_counter()
    pol_b, _, _ = autoscale_policy_search(tr, max_replicas=3,
                                          n_trials=args.trials,
                                          seed=args.seed, **kw)
    pol_a, rep_a, _ = autoscale_policy_search(
        tr, max_replicas=3, n_trials=args.trials, seed=args.seed,
        faults=ft, deadline_cycles=args.deadline, **kw)
    rep_b = simulate_fleet(tr, pol_b, faults=ft,
                           deadline_cycles=args.deadline, **kw)
    dt = time.perf_counter() - t0
    print(f"  search:   fault-blind winner under the crash: "
          f"p99={rep_b.p99:.3e} shed={rep_b.shed} | failure-aware: "
          f"p99={rep_a.p99:.3e} shed={rep_a.shed}  [{dt:.1f}s]")

    # --- 4: the degraded schedule through the real serve path
    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serve.serve_loop import Request, ServeSession
    rng = np.random.default_rng(args.seed)
    n = args.replay_requests
    arr = np.cumsum(rng.exponential(400.0, n)).astype(float)
    new = rng.integers(4, 20, n).astype(float)
    dls = arr + rng.uniform(2e3, 2e4, n)
    sched = [(0.0, ladder[0]), (float(arr[n // 3]), ladder[-1]),
             (float(arr[-3]), ladder[0])]
    cfg = get_config(args.arch)
    if dev.type != "cuda":
        cfg = reduce_config(cfg)
    api = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sess = ServeSession(api, api.init(gen, device=dev), batch_slots=4,
                        S_max=40, device=dev)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=6),
                    max_new=int(new[i]), arrival=float(arr[i]),
                    deadline=float(dls[i])) for i in range(n)]
    rep = sess.serve_open_loop(reqs, step_cycles=60.0, prefill_cycles=180.0,
                               step_schedule=sched, switch_cycles=90.0)
    adm, comp = open_loop_schedule(arr, new, batch_slots=sess.B,
                                   step_cycles=60.0, prefill_cycles=180.0,
                                   deadlines=dls, step_schedule=sched,
                                   switch_cycles=90.0)
    twin = (np.array_equal(rep.admissions, adm)
            and np.array_equal(rep.completions, comp))
    print(f"  replay:   {n} requests through the real serve path "
          f"({cfg.name}, {cfg.num_layers} layers x {cfg.d_model}, "
          f"{cfg.dtype}, {dev}): twin-identical={twin}, shed={rep.shed}, "
          f"rung stalls={rep.switch_stalls}")
    return {"crash": {"shed": int(plain.shed), "p99": plain.p99,
                      "cost": plain.replica_cycles},
            "degrade": {"shed": int(soft.shed), "ladder": list(ladder),
                        "rung_moves": len(soft.rung_timeline) - 1,
                        "cost": soft.replica_cycles},
            "search": {"blind_p99": rep_b.p99, "blind_shed": int(rep_b.shed),
                       "aware_p99": rep_a.p99,
                       "aware_shed": int(rep_a.shed)},
            "replay": {"requests": n, "twin_identical": twin,
                       "shed": int(rep.shed),
                       "switch_stalls": int(rep.switch_stalls),
                       "decode_steps": rep.decode_steps}}


def _sparse_stack(cfg, seed):
    from repro_torch.core.perf_model import cnn_layer_costs
    rng = np.random.default_rng(seed)
    layers = cnn_layer_costs(cfg)
    for l in layers:
        l.s_w = float(rng.uniform(0.1, 0.8))
        l.s_a = float(rng.uniform(0.1, 0.6))
    return layers


if __name__ == "__main__":
    main()
