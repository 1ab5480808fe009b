"""Does one seed give one Table II on the card? For each of the five paper
CNNs at 224 x 224, ``search_run.trained_cnn`` (20 SGD steps, seed 0) runs
twice as it is, under ``deterministic_convolutions``, and twice with that
block taken out (cuDNN's default algorithms); each pair's parameters are
compared bit for bit. Then Table II (``benchmarks_torch.table2_models.run``,
24 trials a model, as ``benchmarks_torch.run --full`` runs it) twice, into
two directories under ``--out-dir``, and each model's rows compared field
for field, apart from the search's wall-clock seconds.

    python3 tools/warmup_repeat_torch.py --out-dir DIR   # needs one CUDA device

Prints one JSON line per model's warm-ups, one for the two Table II runs,
and a summary line: ``"repeats": true`` when the deterministic warm-ups and
the two Table II runs agree.
"""
import argparse
import contextlib
import json
import os
import sys
from unittest import mock

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _diff(a, b) -> tuple:
    """(bit-equal, largest |a - b|) over two parameter trees."""
    import torch
    equal, worst = True, 0.0
    for n in a:
        for k in a[n]:
            x, y = a[n][k], b[n][k]
            equal &= bool(torch.equal(x.view(torch.int32),
                                      y.view(torch.int32)))
            worst = max(worst, float((x - y).abs().max()))
    return equal, worst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True,
                    help="where the two Table II runs write their results")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("warmup_repeat_torch: needs a CUDA device")
    from benchmarks_torch import table2_models
    from repro_torch import search_run
    from repro_torch.configs.paper_cnns import PAPER_CNNS
    dev = torch.device("cuda")
    warm_ok = True
    for cfg in PAPER_CNNS:
        row = {"model": cfg.name, "img_res": cfg.img_res}
        for tag, ctx in (("deterministic", None),
                         ("cudnn_default", contextlib.nullcontext)):
            with (mock.patch.object(search_run, "deterministic_convolutions",
                                    ctx) if ctx else contextlib.nullcontext()):
                a = search_run.trained_cnn(cfg, steps=20, device=dev)
                b = search_run.trained_cnn(cfg, steps=20, device=dev)
            equal, worst = _diff(a, b)
            row[tag] = {"bit_equal": equal, "max_abs_diff": worst}
        warm_ok &= row["deterministic"]["bit_equal"]
        print(json.dumps(row), flush=True)
        del a, b
        torch.cuda.empty_cache()

    runs = []
    for i in range(2):
        out = os.path.join(args.out_dir, f"table2_run{i + 1}")
        runs.append(table2_models.run(iters=24, img_res=224, device=dev,
                                      out_dir=out))
    differ = {name: sorted(k for k in runs[0][name]
                           if k != "search_s"
                           and runs[0][name][k] != runs[1][name][k])
              for name in runs[0]}
    print(json.dumps({"table2_eff_ratio": {n: [r[n]["eff_ratio"]
                                               for r in runs]
                                           for n in runs[0]},
                      "table2_acc_proxy": {n: [r[n]["acc_proxy"]
                                               for r in runs]
                                           for n in runs[0]},
                      "fields_that_differ": differ}), flush=True)
    t2_ok = not any(differ.values())
    from repro_torch.kernels.kernel_costs import card_record
    print(json.dumps({"card": card_record(dev),
                      "deterministic_warmups_bit_equal": warm_ok,
                      "table2_runs_equal": t2_ok,
                      "repeats": warm_ok and t2_ok}))


if __name__ == "__main__":
    main()
