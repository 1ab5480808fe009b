"""Pattern-aware sparsity search of the PyTorch port (DESIGN.md §16): the TPE
picks a sparsity PATTERN (unstructured / N:M / hierarchical / activation) per
matrix kind, jointly with its level, priced by per-pattern decode factors
from ``repro_torch.kernels.kernel_costs``. The flow of
``examples/sparsity_patterns.py``.

On the card the factors are device times: the table
``experiments/kernel_costs_h100.json`` is read where it was measured on a card
of this name at the main-path shape (a ResNet-18 layer-3 im2col product),
else measured and written there. ``--device cpu`` takes the modeled table
(schedule counts, no device time) and says so.

    PYTHONPATH=src python examples/sparsity_patterns_torch.py --iters 24
    PYTHONPATH=src python examples/sparsity_patterns_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--config", default="qwen3-0.6b")
    ap.add_argument("--meas", type=float, default=0.05,
                    help="Eq. 6 weight of the measured decode-cost term")
    ap.add_argument("--device", default="cuda",
                    help="cuda (needs a card) or cpu (explicit request)")
    args = ap.parse_args()

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.core.hass import Lambdas, LMEvaluator, hass_search
    from repro_torch.core.perf_model import TPUModel
    from repro_torch.device import resolve_device
    from repro_torch.kernels import kernel_costs

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        costs_path = os.path.join(os.path.dirname(__file__), "..",
                                  kernel_costs.DEFAULT_PATH)
        table = kernel_costs.load_or_measure(
            costs_path, kernel_costs.MAIN_PATH_CONFIG, device=dev)
        print(f"decode factors measured on {table['device']['name']} "
              f"({table['device']['power_limit']}), device time per unit "
              f"of skippable work:")
    else:
        table = kernel_costs.measure(kernel_costs.MAIN_PATH_CONFIG,
                                     device="cpu")
        print("decode factors MODELED on the CPU (schedule counts, no "
              "device time), cycles per unit of skippable work:")
    factors = table["decode_factors"]
    for p in pruning.PATTERNS:
        print(f"  {p:13s} {factors[p]:.4f}")

    cfg = get_config(args.config)
    tpu = TPUModel(chips=1)
    lam = Lambdas(meas=args.meas)
    kw = dict(iters=args.iters, seed=0, include_act=False, lambdas=lam)

    # both arms carry a dense x0 anchor so the trial sets always contain
    # the don't-prune point (DESIGN.md §16)
    ev_u = LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=150)
    r_u = hass_search(ev_u, ev_u.n_search, **kw,
                      x0=np.zeros(ev_u.n_search))

    ev_p = LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=150,
                       patterns=pruning.PATTERNS, pattern_costs=factors)
    r_p = hass_search(ev_p, ev_p.n_search, **kw,
                      x0=np.zeros(2 * ev_p.n_search))

    n = ev_p.n_search
    codes = np.clip(r_p.best_x[-n:].astype(np.int64), 0,
                    len(ev_p.patterns) - 1)
    s_w = np.clip(r_p.best_x[:n], 0.0, 1.0)
    print(f"\nbest pattern assignment ({args.config}, {args.iters} trials):")
    for k, name in enumerate(ev_p.group_names):
        print(f"  {name:14s} {ev_p.patterns[codes[k]]:13s} s={s_w[k]:.2f}")

    mu, mp = r_u.best_metrics, r_p.best_metrics
    print(f"\nunstructured-only: acc={mu['acc']:.3f} thr={mu['thr']:.0f} "
          f"tok/s dsp={mu['dsp']:.3f} score={mu['score']:.4f}")
    print(f"pattern-aware    : acc={mp['acc']:.3f} thr={mp['thr']:.0f} "
          f"tok/s dsp={mp['dsp']:.3f} meas={mp.get('meas', 0.0):.3f} "
          f"score={mp['score']:.4f}")


if __name__ == "__main__":
    main()
