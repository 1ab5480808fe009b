"""Deployment simulation demo of the PyTorch port (DESIGN.md §13): search ->
partition -> simulate -> SLO-aware pick, the flow of
``examples/deploy_sim.py`` through ``repro_torch``.

Runs a quick LM sparsity search, partitions the best stack across chips
with the analytic max-min DP, then replays a bursty (MMPP) request trace
through the discrete-event simulator and lets ``objective="slo"`` re-pick
the cuts against a p99 latency target. Optionally closes the loop inside
the search itself (``--lat-weight``): proposals are scored with a
simulated-latency Eq. 6 term via ``SimLatencyEvaluator``.

The whole flow is host code (the analytic evaluator, the DSE and the
simulator are numpy): ``--device`` only says where a caller would run the
device half, and ``cuda`` (the default) needs a card like every entry point
of the port; ``--device cpu`` is the explicit request to run without one.

    PYTHONPATH=src python examples/deploy_sim_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="qwen3_0_6b")
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8, help="TPE iterations")
    ap.add_argument("--requests", type=int, default=600,
                    help="trace length (requests)")
    ap.add_argument("--util", type=float, default=0.45,
                    help="mean offered load as a fraction of the max-min "
                         "pick's steady rate")
    ap.add_argument("--req-tokens", type=int, default=32,
                    help="decode tokens per request")
    ap.add_argument("--slo-x", type=float, default=3.0,
                    help="p99 SLO as a multiple of the single-chip "
                         "service time per request")
    ap.add_argument("--max-cuts", type=int, default=10)
    ap.add_argument("--dse-iters", type=int, default=200)
    ap.add_argument("--lat-weight", type=float, default=0.0,
                    help="> 0 adds the simulated-latency Eq. 6 term to the "
                         "search itself (SimLatencyEvaluator)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu (explicit request)")
    args = ap.parse_args()

    import numpy as np

    from repro_torch.core.hass import Lambdas, LMEvaluator, hass_search
    from repro_torch.deploy_run import deploy_compare
    from repro_torch.device import resolve_device
    from repro_torch.sim import SimLatencyEvaluator

    dev = resolve_device(args.device)
    print(f"device: {dev} (the deployment flow below is host code)")
    d = deploy_compare(config=args.config, chips=args.chips,
                       iters=args.iters, requests=args.requests,
                       util=args.util, req_tokens=args.req_tokens,
                       slo_x=args.slo_x, max_cuts=args.max_cuts,
                       dse_iters=args.dse_iters, seed=args.seed)
    cfg, tpu, res, trace = d["cfg"], d["tpu"], d["result"], d["trace"]
    mm = d["maxmin"]
    print(f"{cfg.name}: best proposal acc={res.best_metrics['acc']:.3f} "
          f"thr={res.best_metrics['thr']:.1f} tok/s "
          f"({len(d['layers'])} workloads, {len(d['cut_points'])} "
          f"candidate cuts)")
    print(f"trace: {trace.kind}, {len(trace)} requests x "
          f"{args.req_tokens} tok, offered "
          f"{trace.offered_load * tpu.freq:.0f} tok/s "
          f"({trace.offered_load / mm.steady_throughput:.0%} of max-min "
          f"steady rate)")
    print(f"SLO: p99 <= {d['slo'].target / tpu.freq * 1e3:.2f} ms")
    for tag, p in (("maxmin", mm), ("slo", d["slo_pick"])):
        rep = d["reports"][tag]
        print(f"  {tag:6s}: cuts={p.cuts} "
              f"steady={p.steady_throughput * tpu.freq:8.1f} tok/s  "
              f"sim p50/p99={rep.p50 / tpu.freq * 1e3:6.2f}/"
              f"{rep.p99 / tpu.freq * 1e3:6.2f} ms  "
              f"util={np.round(rep.utilization, 2)}")
    st = d["cache"].stats()
    print(f"  slo pick in {d['slo_s']:.1f}s; shared DSECache: "
          f"{st['cold_runs']} cold, {st['hits']} exact + {st['warm_hits']} "
          f"warm reuses")

    if args.lat_weight > 0:
        print(f"\nsearch with simulated-latency term "
              f"(lambda_lat={args.lat_weight}):")
        sev = SimLatencyEvaluator(
            LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=args.dse_iters),
            tpu, tpu.chip_budget, trace=trace, slo=d["slo"],
            n_parts=tpu.chips, batch=args.req_tokens,
            dse_iters=args.dse_iters, cut_points=d["cut_points"])
        res2 = hass_search(sev, sev.n_search, iters=args.iters,
                           seed=args.seed, include_act=False,
                           lambdas=Lambdas(lat=args.lat_weight))
        m = res2.best_metrics
        print(f"  best: acc={m['acc']:.3f} thr={m['thr']:.1f} tok/s "
              f"sim p99={m['lat_cycles'] / tpu.freq * 1e3:.2f} ms "
              f"(lat={m['lat']:.2f}x SLO, score={m['score']:.3f})")


if __name__ == "__main__":
    main()
