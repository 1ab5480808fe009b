"""Assemble the §Roofline table from the port's dry run, the twin of
``benchmarks/roofline_report.py``. Host only.

The rows come from ``experiments/dryrun_torch.json``, which
``python -m repro_torch.launch.dryrun --all`` writes (never the JAX
package's ``experiments/dryrun.json``): each cell's sharded step was run on
one rank of a ``fake`` process group and its flops, collective bytes by op
and peak bytes counted from the operations that ran
(``repro_torch.analysis.op_costs``). The table is the reference's, terms
from the H100 data sheet's peaks (``repro_torch.analysis.roofline``);
under each row, the collectives by op (count x result bytes per rank).

    python -m benchmarks_torch.roofline_report [--mesh pod16x16] [--path FILE]
"""
import json
import os

from benchmarks_torch.common import RESULTS_DIR, emit, target

DRYRUN_PATH = os.path.join(RESULTS_DIR, "dryrun_torch.json")


def load(path: str = DRYRUN_PATH):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _by_op(r) -> str:
    """The row's collectives: ``op count x bytes`` per rank, by op."""
    ops = r.get("coll_by_op") or {}
    return "  ".join(f"{op} {c} x {b:.3e} B" for op, (c, b) in
                     sorted(ops.items())) or "none"


def run(mesh: str = "pod16x16", path: str = DRYRUN_PATH, device="cuda",
        out_dir=None):
    target(device, out_dir)
    res = load(path)
    rows = []
    for key, rec in sorted(res.items()):
        if rec.get("status") != "ok" or rec.get("mesh") != mesh:
            continue
        rows.append(rec)
    if not rows:
        print("no dry-run results yet; run python -m "
              "repro_torch.launch.dryrun --all")
        return []
    print(f"{'arch':18s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'coll_s':>10s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s} "
          f"{'HBM GiB':>8s}")
    for r in rows:
        print(f"{r['arch']:18s} {r['shape']:12s} {r['compute_s']:10.3e} "
              f"{r['memory_s']:10.3e} {r['collective_s']:10.3e} "
              f"{r['dominant']:>10s} {r['useful_ratio']:7.2f} "
              f"{100 * r['roofline_frac']:6.1f}% {r['hbm_total_gib']:8.1f}")
        print(f"  collectives: {_by_op(r)}")
    emit("roofline.cells", 0.0, f"n={len(rows)} mesh={mesh}")
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--path", default=DRYRUN_PATH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    run(**vars(ap.parse_args()))
