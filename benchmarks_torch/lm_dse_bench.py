"""LM-workload DSE benchmark (DESIGN.md §11), the port's twin of
``benchmarks/lm_dse_bench.py``. Host only: the DSE engines and the
partition DP are numpy.

Three sections, saved as ``lm_dse_bench_h100.json`` (or, on the CPU,
``<out_dir>/lm_dse_bench_cpu.json``):

  * ``stacks``    — per-config ``lm_layer_costs`` stack shapes (layer
    counts, prunable counts, analytic param counts) for all ten assigned
    architectures.
  * ``dse``       — vectorized ``incremental_dse`` vs the scalar ``_ref``
    oracle on deep LM stacks: identical results asserted, wall-clock and
    speedup reported (the gate: >= 10x).
  * ``partitions`` — 1/4/8-chip segment-table DP partitions of a sparse LM
    stack: sum-form (temporal) vs max-min (spatial steady-rate) objectives,
    with the max-min pick asserted never worse on ``steady_throughput``.

    python -m benchmarks_torch.lm_dse_bench [--smoke] [--device cpu --out-dir DIR]
"""
import argparse
import time

import numpy as np

from benchmarks_torch.common import emit, save_json, target
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.dse import (incremental_dse, incremental_dse_ref,
                                  partition_pipeline)
from repro_torch.core.perf_model import (TPUModel, lm_block_bounds,
                                         lm_layer_costs, param_count,
                                         thin_cut_points,
                                         tile_quantize_sparsity)

DSE_MODELS = ["qwen3-0.6b", "mixtral-8x7b", "deepseek-v3-671b"]
PART_MODELS = ["mixtral-8x7b", "deepseek-v3-671b"]
#: payload fields that are wall-clock readings (everything else is exact)
WALL_CLOCK = ("ref_ms", "new_ms", "speedup", "wall_s", "worst_speedup")


def sparse_lm_stack(name: str, seq_len: int = 2048, seed: int = 1):
    """Sparse ``lm_layer_costs`` stack with tile-quantized weight sparsity
    in the paper's reported range (the TPU backend skips whole tiles only)."""
    layers = lm_layer_costs(get_config(name), seq_len=seq_len)
    rng = np.random.default_rng(seed)
    for l in layers:
        if l.prunable:
            l.s_w = l.s_w_tile = tile_quantize_sparsity(
                float(rng.uniform(0.1, 0.8)), l.m_dot, l.weight_count)
    return layers


def bench_stacks():
    rows = []
    for name in sorted(ASSIGNED):
        cfg = get_config(name)
        layers = lm_layer_costs(cfg)
        row = {"model": name, "layers": len(layers),
               "prunable": sum(1 for l in layers if l.prunable),
               "blocks": len(lm_block_bounds(layers)) + 1,
               "params_b": round(param_count(cfg) / 1e9, 2)}
        rows.append(row)
        print(f"  {name:18s} L={row['layers']:4d} "
              f"prunable={row['prunable']:4d} blocks={row['blocks']:3d} "
              f"params={row['params_b']:8.2f}B")
    return rows


def bench_dse(models, dse_iters: int, reps: int):
    rows = []
    for name in models:
        layers = sparse_lm_stack(name)
        tpu = TPUModel()
        new = incremental_dse(layers, tpu, tpu.budget, max_iters=dse_iters)
        ref = incremental_dse_ref(layers, tpu, tpu.budget,
                                  max_iters=dse_iters)
        assert new.designs == ref.designs and new.trace == ref.trace \
            and new.throughput == ref.throughput \
            and new.resource == ref.resource, name
        # same min-of-reps protocol on both sides: a noise spike in a
        # lone reference timing must not mask (or fake) a regression
        t_new = min(_t(lambda: incremental_dse(layers, tpu, tpu.budget,
                                               max_iters=dse_iters))
                    for _ in range(reps))
        t_ref = min(_t(lambda: incremental_dse_ref(layers, tpu, tpu.budget,
                                                   max_iters=dse_iters))
                    for _ in range(reps))
        row = {"model": name, "layers": len(layers), "dse_iters": dse_iters,
               "ref_ms": round(t_ref * 1e3, 1),
               "new_ms": round(t_new * 1e3, 1),
               "speedup": round(t_ref / t_new, 1)}
        rows.append(row)
        print(f"  {name:18s} L={row['layers']:4d} "
              f"ref={row['ref_ms']:8.1f}ms new={row['new_ms']:6.1f}ms "
              f"{row['speedup']:6.1f}x")
    return rows


def bench_partitions(models, chips_list, dse_iters: int, max_cuts: int,
                     batch: int = 64):
    rows = []
    for name in models:
        layers = sparse_lm_stack(name)
        cut_points = thin_cut_points(lm_block_bounds(layers), max_cuts)
        for chips in chips_list:
            tpu = TPUModel(chips=chips)
            kw = dict(n_parts=chips, batch=batch, dse_iters=dse_iters,
                      cut_points=cut_points)
            if chips == 1:
                t0 = time.perf_counter()
                p = partition_pipeline(layers, tpu, tpu.chip_budget, **kw)
                dt = time.perf_counter() - t0
                row = {"model": name, "chips": 1, "objective": p.objective,
                       "cuts": p.cuts, "wall_s": round(dt, 2),
                       "steady_tok_s": round(p.steady_throughput * tpu.freq, 2),
                       "amortized_tok_s": round(p.throughput * tpu.freq, 2)}
                rows.append(row)
                print(f"  {name:18s} x1  "
                      f"thr={row['amortized_tok_s']:8.1f} tok/s "
                      f"({dt:5.1f}s)")
                continue
            picks = {}
            for objective in ("sum", "maxmin"):
                t0 = time.perf_counter()
                p = partition_pipeline(layers, tpu, tpu.chip_budget,
                                       objective=objective, **kw)
                picks[objective] = p
                rows.append({
                    "model": name, "chips": chips, "objective": objective,
                    "cuts": p.cuts,
                    "wall_s": round(time.perf_counter() - t0, 2),
                    "steady_tok_s": round(p.steady_throughput * tpu.freq, 2),
                    "amortized_tok_s": round(p.throughput * tpu.freq, 2),
                    "dse_calls": p.dse_calls})
            sm, mm = picks["sum"], picks["maxmin"]
            assert mm.steady_throughput >= \
                sm.steady_throughput * (1 - 1e-12), (name, chips)
            gain = mm.steady_throughput / max(sm.steady_throughput, 1e-30)
            print(f"  {name:18s} x{chips}  "
                  f"steady sum={sm.steady_throughput * tpu.freq:8.1f} "
                  f"maxmin={mm.steady_throughput * tpu.freq:8.1f} tok/s "
                  f"({gain:.2f}x)  cuts sum={sm.cuts} maxmin={mm.cuts}")
    return rows


def _t(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(smoke: bool = False, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    dse_models = DSE_MODELS[:1] if smoke else DSE_MODELS
    part_models = PART_MODELS[:1] if smoke else PART_MODELS
    chips_list = (1, 4) if smoke else (1, 4, 8)
    dse_iters = 120 if smoke else 300
    max_cuts = 8 if smoke else 12
    print("lm_layer_costs stacks (all assigned archs)")
    stacks = bench_stacks()
    print("incremental_dse on LM stacks: scalar reference vs vectorized")
    dse_rows = bench_dse(dse_models, dse_iters=dse_iters,
                         reps=2 if smoke else 3)
    print(f"partition_pipeline on sparse LM stacks (chips={list(chips_list)})")
    part_rows = bench_partitions(part_models, chips_list,
                                 dse_iters=dse_iters, max_cuts=max_cuts)
    worst = min(r["speedup"] for r in dse_rows)
    save_json("lm_dse_bench", {
        "smoke": smoke, "stacks": stacks, "dse": dse_rows,
        "partitions": part_rows, "worst_speedup": worst}, dev, out_dir)
    emit("lm_dse_bench.incremental_dse",
         sum(r["new_ms"] for r in dse_rows) * 1e3,
         f"worst={worst:.1f}x over {len(dse_rows)} LM stacks "
         f"(L={max(r['layers'] for r in dse_rows)})")
    assert worst >= 10.0, f"LM-stack DSE speedup regressed: {worst:.1f}x"
    return {"stacks": stacks, "dse": dse_rows, "partitions": part_rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced set for CI (one DSE model, 1/4-chip)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device, out_dir=args.out_dir)
