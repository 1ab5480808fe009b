"""The port's benchmark harness: one entry per paper table/figure, the
roofline report and each gate of ``benchmarks/run.py``, under the same job
names in the same order.

    python -m benchmarks_torch.run                      # on the card
    python -m benchmarks_torch.run --only fig5,table2 --full
    python -m benchmarks_torch.run --device cpu --out-dir "$TMPDIR/bench"
    python -m benchmarks_torch.run --only sim,lm_dse,fleet,chaos,obs,roofline

Prints ``name,us_per_call,derived`` CSV rows and writes
``bench_summary_h100.json`` (``bench_summary_full_h100.json`` with
``--full``; ``_cpu`` on the host) beside the jobs' own
results: one row per executed job (name, wall seconds, pass/fail, the
scalar metrics of its payload, the launches of each CUDA kernel it made,
and for a failed job its error). A failed job makes the run exit 1.
``--full`` is the paper's budget (96 TPE iterations per Fig. 5 arm, 24 per
Table II model); the CNN searches run at 224 x 224, the published
resolution, on the card, and at 64 x 64, the JAX scripts' default, on the
host. ``roofline`` reads the port's dry run
(``experiments/dryrun_torch.json``). The gates (``dse`` ... ``obs``) run
their smoke subsets unless ``--full`` is given, as the reference's do.
"""
import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

JOBS = ("kernels", "fig4", "fig6", "fig1", "fig5", "table2", "roofline", "dse",
        "lm_dse", "search", "sim", "fleet", "sparsity", "chaos", "obs")


def _scalar_metrics(payload, prefix: str = "", depth: int = 2) -> dict:
    """The payload's top-level scalars (one nesting level of dicts is
    flattened as ``outer.inner``)."""
    out = {}
    if not isinstance(payload, dict):
        return out
    for k, v in payload.items():
        if isinstance(v, bool) or isinstance(v, (int, float, str)):
            out[prefix + str(k)] = v
        elif isinstance(v, dict) and depth > 1:
            for kk, vv in v.items():
                if isinstance(vv, (bool, int, float, str)):
                    out[f"{prefix}{k}.{kk}"] = vv
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-budget searches (96 TPE iters)")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(JOBS))
    ap.add_argument("--list", action="store_true",
                    help="print registered job names and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu (explicit request)")
    ap.add_argument("--out-dir", default=None,
                    help="where results go (needed with --device cpu; "
                         "default on the card: experiments/)")
    args = ap.parse_args(argv)
    if args.list:
        for name in JOBS:
            print(name)
        return
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(JOBS):
        ap.error(f"unknown jobs {sorted(only - set(JOBS))}")

    from benchmarks_torch import (chaos_bench, dse_bench, fig1_frontier,
                                  fig4_dse_allocation, fig5_search_compare,
                                  fig6_speedup, fleet_bench, kernels_bench,
                                  lm_dse_bench, obs_bench, roofline_report,
                                  search_bench, sim_bench, sparsity_bench,
                                  table2_models)
    from benchmarks_torch.common import save_json, target
    from repro_torch import kernels
    dev, out_dir = target(args.device, args.out_dir)
    iters = 96 if args.full else 10
    t2_iters = 24 if args.full else 8
    smoke = not args.full
    res = 224 if dev.type == "cuda" else 64
    kw = dict(device=dev, out_dir=out_dir)
    jobs = {
        "kernels": lambda: kernels_bench.run(**kw),
        "fig4": lambda: fig4_dse_allocation.run(**kw),
        "fig6": lambda: fig6_speedup.run(**kw),
        "fig1": lambda: fig1_frontier.run(iters=max(iters // 2, 8),
                                          img_res=res, **kw),
        "fig5": lambda: fig5_search_compare.run(iters=iters, img_res=res,
                                                **kw),
        "table2": lambda: table2_models.run(iters=t2_iters, img_res=res,
                                            **kw),
        "roofline": lambda: roofline_report.run(**kw),
        "dse": lambda: dse_bench.run(**kw),
        "lm_dse": lambda: lm_dse_bench.run(smoke=smoke, **kw),
        "search": lambda: search_bench.run(smoke=smoke, **kw),
        "sim": lambda: sim_bench.run(smoke=smoke, **kw),
        "fleet": lambda: fleet_bench.run(smoke=smoke, **kw),
        "sparsity": lambda: sparsity_bench.run(smoke=smoke, **kw),
        "chaos": lambda: chaos_bench.run(smoke=smoke, **kw),
        "obs": lambda: obs_bench.run(smoke=smoke, **kw),
    }
    print("name,us_per_call,derived")
    failures = 0
    summary = []
    for name in JOBS:
        if only and name not in only:
            continue
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        row = {"job": name}
        try:
            payload = jobs[name]()
            row.update(ok=True, metrics=_scalar_metrics(payload))
        except Exception as e:                                # noqa: BLE001
            failures += 1
            traceback.print_exc()
            print(f"{name},0,FAILED")
            row.update(ok=False, metrics={},
                       error=f"{type(e).__name__}: {e}")
        row["wall_s"] = round(time.perf_counter() - t0, 3)
        row["launches"] = kernels.launch_counts()
        summary.append(row)
    # a --full run keeps the default run's summary beside its own
    save_json("bench_summary_full" if args.full else "bench_summary",
              {"full": args.full, "failures": failures, "img_res": res,
               "jobs": summary}, dev, out_dir)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
