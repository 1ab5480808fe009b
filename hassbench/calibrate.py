"""Readings that the limits of a cell's check are set from: for each seed,
one run's set-up and a short window at the cell's own load, then the
numbers that ``harness.check`` compares, for the program and for the
control (the reference in TF32 with its DSE in float32, in the program's
place), over the same sampled proposals. All seeds in one process.

    python3 hassbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --seconds 6 --out chiprun_out/calibrate.jsonl

Needs a card; the benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(s, w, candidate, sample):
    """The numbers ``harness.check`` compares, and beside them where the
    answers part: the widest clipped-count gap as a share of its input, the
    widest count gap by layer, and the widest accuracy margin needed."""
    import numpy as np
    from hassbench import harness
    from hassbench.reference import compare
    a = harness.answers(s, w, candidate, sample)
    out = compare.numbers(a["cand"], a["ref"], a["dense_pred"],
                          a["cand_hw"], a["ref_hw"])
    out["compared"] = a["compared"]
    ref = a["reference"]
    gap = np.abs(a["cand"]["a_zeros"] - a["ref"]["a_zeros"])
    out["s_a_gap"] = float((gap / ref.a_numel).max())
    out["a_count_gap_by_layer"] = dict(zip(
        [l.name for l in ref.prunable], gap.max(0).tolist()))
    out["acc_gap"] = max(compare.acc_margin_gap(x, z, a["dense_pred"])
                         for x, z in zip(a["cand"]["acc"], a["ref"]["logits"]))
    return out


def main(argv=None) -> int:
    import gc

    import torch
    from hassbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sample", type=int, default=None,
                    help="proposals compared (default: the cell's sample)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(a.workload)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "a") as f:
        for seed in a.seeds:
            t0 = time.perf_counter()
            s = harness.setup(cell, seed)
            setup_s = time.perf_counter() - t0
            w = harness.run_window(s, a.seconds, False)
            s.probe = s.ev = None
            gc.unfreeze()
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            prog = readings(s, w, "program", a.sample)
            t2 = time.perf_counter()
            ctrl = readings(s, w, "control", a.sample) \
                if a.control else None
            rec = {"workload": cell.name, "seed": seed, "setup_s": setup_s,
                   "trials_per_s": w.trials / w.seconds,
                   "check_s": t2 - t1, "control_s": time.perf_counter() - t2,
                   "program": prog, "control": ctrl}
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
            del s, w
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
