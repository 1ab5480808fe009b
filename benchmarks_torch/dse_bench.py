"""Vectorized-DSE benchmark: old (scalar reference) vs new (array-native)
``incremental_dse`` wall-clock on the paper's five CNN workloads, the
segment-table partition DP against the SA baseline, and batched-vs-serial
HASS search-engine throughput (trials/sec). Host only.

The vectorized engine must be *identical* to the reference (designs,
throughput, resource, trace — asserted here) and >= 10x faster; this is the
port's copy of the JAX package's acceptance gate.

    python -m benchmarks_torch.dse_bench [--device cpu --out-dir DIR]
"""
import time

import numpy as np

from benchmarks_torch.common import emit, save_json, target, timed
from repro_torch.configs.paper_cnns import (MOBILENETV2, MOBILENETV3L,
                                            MOBILENETV3S, RESNET18, RESNET50)
from repro_torch.core.dse import (incremental_dse, incremental_dse_ref,
                                  partition_pipeline, partition_pipeline_sa)
from repro_torch.core.hass import hass_search
from repro_torch.core.perf_model import FPGAModel, TPUModel, cnn_layer_costs

PAPER_CNNS = [("resnet18", RESNET18), ("resnet50", RESNET50),
              ("mobilenetv2", MOBILENETV2), ("mobilenetv3s", MOBILENETV3S),
              ("mobilenetv3l", MOBILENETV3L)]
#: payload fields that are wall-clock readings (everything else is exact)
WALL_CLOCK = ("ref_ms", "new_ms", "speedup", "dse_per_s", "dp_ms", "sa_ms",
              "engine_trials_per_s", "worst_speedup", "mean_speedup")


def _sparse_workload(cfg, seed: int = 1):
    """Per-layer sparsity stats in the paper's reported range (§VI)."""
    rng = np.random.default_rng(seed)
    layers = cnn_layer_costs(cfg)
    for l in layers:
        l.s_w = float(rng.uniform(0.1, 0.8))
        l.s_a = float(rng.uniform(0.1, 0.6))
        l.s_w_tile = float(rng.uniform(0.0, 0.4))
    return layers


def _best_of(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_dse(reps: int = 5, ref_reps: int = 2):
    rows = []
    for name, cfg in PAPER_CNNS:
        layers = _sparse_workload(cfg)
        for hw_name, hw, budget in (("fpga", FPGAModel(), 12288.0),
                                    ("tpu", TPUModel(), TPUModel().budget)):
            new = incremental_dse(layers, hw, budget)
            ref = incremental_dse_ref(layers, hw, budget)
            assert new.designs == ref.designs and new.trace == ref.trace \
                and new.throughput == ref.throughput \
                and new.resource == ref.resource, (name, hw_name)
            t_new = _best_of(lambda: incremental_dse(layers, hw, budget), reps)
            t_ref = _best_of(lambda: incremental_dse_ref(layers, hw, budget),
                             ref_reps)
            row = {"model": name, "hw": hw_name, "layers": len(layers),
                   "increments": len(new.trace),
                   "ref_ms": round(t_ref * 1e3, 2),
                   "new_ms": round(t_new * 1e3, 2),
                   "speedup": round(t_ref / t_new, 1),
                   "dse_per_s": round(1.0 / t_new, 1)}
            rows.append(row)
            print(f"  {name:13s} {hw_name:4s} L={row['layers']:3d} "
                  f"ref={row['ref_ms']:8.1f}ms new={row['new_ms']:6.1f}ms "
                  f"{row['speedup']:6.1f}x  ({row['dse_per_s']:.0f} DSE/s)")
    return rows


def bench_search_engine(iters: int = 64, dim: int = 16):
    """Search-loop overhead with a free evaluator: trials/sec of the serial
    ask/tell loop vs the batched frontier."""

    def synth(x):
        return {"acc": float(np.cos(3 * x).mean()), "spa": float(np.mean(x)),
                "thr": 1.0 + float(np.sum(x)),
                "thr_norm": float(np.tanh(np.mean(x))),
                "dsp": float(np.mean(x) ** 2)}

    out = {}
    for label, kw in (("serial", {}), ("batch8", {"batch_size": 8}),
                      ("batch16", {"batch_size": 16})):
        t0 = time.perf_counter()
        r = hass_search(synth, dim // 2, iters=iters, seed=0, **kw)
        dt = time.perf_counter() - t0
        assert len(r.trials) == iters
        out[label] = round(iters / dt, 1)
        print(f"  search engine {label:8s} {out[label]:10.1f} trials/s")
    return out


def bench_partition(n_parts: int = 3, batch: int = 256,
                    reconfig: float = 1e6, dse_iters: int = 120):
    """Segment-table DP vs the SA baseline: the DP optimum is exact
    (``thr_gain`` >= 1 by construction); plus the partitioned multi-chip
    TPU mode (ICI-aware switches)."""
    rows = []
    for name, cfg in (("resnet18", RESNET18), ("mobilenetv3s", MOBILENETV3S)):
        layers = _sparse_workload(cfg)
        hw, budget = FPGAModel(), 4096.0
        kw = dict(n_parts=n_parts, batch=batch, reconfig_cycles=reconfig,
                  dse_iters=dse_iters)
        dp, us_dp = timed(lambda: partition_pipeline(layers, hw, budget, **kw))
        sa, us_sa = timed(lambda: partition_pipeline_sa(layers, hw, budget,
                                                        seed=0, **kw))
        assert dp.throughput >= sa.throughput * (1 - 1e-12), (name, "DP<SA")
        row = {"model": name, "hw": "fpga", "layers": len(layers),
               "dp_ms": round(us_dp / 1e3, 2), "sa_ms": round(us_sa / 1e3, 2),
               "dp_thr": dp.throughput, "sa_thr": sa.throughput,
               "thr_gain": round(dp.throughput / max(sa.throughput, 1e-30), 3),
               "dse_calls": dp.dse_calls, "cuts": dp.cuts}
        rows.append(row)
        print(f"  partition {name:13s} DP={row['dp_ms']:8.1f}ms "
              f"SA={row['sa_ms']:8.1f}ms thr_gain={row['thr_gain']:.3f}x "
              f"dse_calls={dp.dse_calls} cuts={dp.cuts}")
    layers = _sparse_workload(RESNET18)
    tpu = TPUModel(chips=4)
    mp = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=4,
                            batch=batch, dse_iters=dse_iters)
    rows.append({"model": "resnet18", "hw": "tpu_x4", "layers": len(layers),
                 "dp_thr": mp.throughput, "steady_thr": mp.steady_throughput,
                 "dse_calls": mp.dse_calls, "cuts": mp.cuts})
    print(f"  partition resnet18 tpu_x4 cuts={mp.cuts} "
          f"amortized={mp.throughput * tpu.freq:.0f} "
          f"steady={mp.steady_throughput * tpu.freq:.0f} img/s")
    return rows


def run(reps: int = 5, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    print("incremental_dse: scalar reference vs vectorized")
    rows = bench_dse(reps=reps)
    print("partition_pipeline: segment-table DP vs SA baseline")
    part_rows = bench_partition()
    print("hass_search engine throughput (synthetic evaluator)")
    engine = bench_search_engine()
    worst = min(r["speedup"] for r in rows)
    mean = float(np.mean([r["speedup"] for r in rows]))
    save_json("dse_bench", {"rows": rows, "partition": part_rows,
                            "engine_trials_per_s": engine,
                            "worst_speedup": worst,
                            "mean_speedup": round(mean, 1)}, dev, out_dir)
    total_new = sum(r["new_ms"] for r in rows)
    emit("dse_bench.incremental_dse", total_new * 1e3,
         f"worst={worst:.1f}x mean={mean:.1f}x over "
         f"{len(rows)} paper-CNN workloads")
    assert worst >= 10.0, f"vectorized DSE speedup regressed: {worst:.1f}x"
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(device=args.device, out_dir=args.out_dir)
