"""Deployment-simulator gates (DESIGN.md §13), the port's twin of
``benchmarks/sim_bench.py``. Host only: the simulator, the DSE and the
partition search are numpy.

Three sections, saved as ``sim_bench_h100.json`` (or, on the CPU,
``<out_dir>/sim_bench_cpu.json``):

  * ``agreement`` — the sim-vs-analytic contract: across randomized sparse
    stacks (CNN + LM), chip counts, DP objectives, heterogeneous budgets,
    and the temporal schedule, the simulator's backlogged saturation rate
    must match the analytic model (``steady_throughput`` spatial,
    amortized ``throughput`` temporal) within ``SIM_TOL``. Hard gate.
  * ``slo`` — the rate/latency trade-off scenario: a stack whose ICI hops
    are moderately expensive (priced just below the stage rates, so the
    max-min DP still takes them for 4x saturation) serving a bursty MMPP
    trace at mid utilization. ``objective="slo"`` must pick a partition
    with strictly lower simulated p99 than the max-min pick — the
    acceptance gate: the SLO binds and the search walks away from the
    rate-optimal cuts.
  * ``latency`` — report-only: tail latencies of a searched sparse LM
    stack across traffic shapes (poisson / mmpp / diurnal) and offered
    loads on a 4-chip slice.

    python -m benchmarks_torch.sim_bench [--smoke] [--device cpu --out-dir DIR]
"""
import argparse

import numpy as np

from benchmarks_torch.common import emit, save_json, target
from benchmarks_torch.dse_bench import _sparse_workload as _sparse_cnn
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.paper_cnns import MOBILENETV3S, RESNET18
from repro_torch.core.dse import partition_pipeline
from repro_torch.core.perf_model import (ACT_BYTES, ICI_BW, ICI_LINKS,
                                         FPGAModel, LayerCost, TPUModel,
                                         lm_block_bounds, lm_layer_costs,
                                         thin_cut_points)
from repro_torch.sim import (SIM_TOL, SLO, diurnal_trace, mmpp_trace,
                             poisson_trace, request_rate,
                             saturation_throughput, simulate_partition)
from repro_torch.sim.slo import latency_percentile


def _sparse_lm(arch, seed, reduced=True):
    cfg = get_config(arch)
    layers = lm_layer_costs(reduce_config(cfg) if reduced else cfg,
                            seq_len=128)
    rng = np.random.default_rng(seed)
    for l in layers:
        if l.prunable:
            l.s_w = l.s_w_tile = float(rng.uniform(0.0, 0.8))
    return layers


def bench_agreement(smoke: bool):
    """Fuzzed sim-vs-analytic saturation agreement (hard gate: SIM_TOL)."""
    cases = []
    seeds = (0, 1) if smoke else (0, 1, 2, 3)
    for seed in seeds:
        cases.append(("cnn", _sparse_cnn(MOBILENETV3S, seed),
                      None, 2 + seed % 3, "maxmin"))
        cases.append(("lm", _sparse_lm("qwen3-0.6b", seed), "blocks",
                      2 + (seed + 1) % 3, "sum"))
    rows = []
    worst = 0.0
    for tag, layers, cuts, chips, objective in cases:
        tpu = TPUModel(chips=chips)
        cut_points = lm_block_bounds(layers) if cuts == "blocks" else None
        p = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=chips,
                               batch=32, dse_iters=100, objective=objective,
                               cut_points=cut_points)
        sat = saturation_throughput(layers, tpu, p, n_requests=64)
        err = abs(sat - p.steady_throughput) / p.steady_throughput
        worst = max(worst, err)
        rows.append({"workload": tag, "chips": chips,
                     "objective": objective, "cuts": p.cuts,
                     "steady_analytic": p.steady_throughput,
                     "steady_sim": sat, "rel_err": err})
    # heterogeneous slice
    layers = _sparse_cnn(RESNET18, 7)
    het = TPUModel(chips=3, chip_lanes=(512.0, 256.0, 384.0))
    p = partition_pipeline(layers, het, het.chip_budget, n_parts=3,
                           batch=32, dse_iters=100, objective="maxmin")
    sat = saturation_throughput(layers, het, p, n_requests=64)
    err = abs(sat - p.steady_throughput) / p.steady_throughput
    worst = max(worst, err)
    rows.append({"workload": "cnn_hetero", "chips": 3, "objective": "maxmin",
                 "chip_budgets": p.chip_budgets, "cuts": p.cuts,
                 "steady_analytic": p.steady_throughput, "steady_sim": sat,
                 "rel_err": err})
    # temporal schedule: amortized rate at size == batch
    layers = _sparse_cnn(RESNET18, 8)
    fpga = FPGAModel()
    p = partition_pipeline(layers, fpga, 4096.0, n_parts=3, batch=64,
                           reconfig_cycles=1e6, dse_iters=100)
    sat = saturation_throughput(layers, fpga, p, reconfig_cycles=1e6)
    err = abs(sat - p.throughput) / p.throughput
    worst = max(worst, err)
    rows.append({"workload": "cnn_temporal", "chips": 1, "objective": "sum",
                 "cuts": p.cuts, "amortized_analytic": p.throughput,
                 "amortized_sim": sat, "rel_err": err})
    print(f"  agreement: {len(rows)} randomized partitions, worst rel err "
          f"{worst:.2e} (tol {SIM_TOL:.0e})")
    assert worst <= SIM_TOL, \
        f"sim-vs-analytic saturation diverged: {worst:.3e} > {SIM_TOL:.0e}"
    return rows, worst


def _uniform_stack(L: int, width: int, act: float):
    """L identical dense matmul stages with controllable boundary width —
    the knob that prices the ICI hops relative to the stage rates."""
    return [LayerCost(name=f"l{i}", macs=width * width, m_dot=width,
                      weight_count=width * width, act_in=act, act_out=act,
                      kind="linear", prunable=False) for i in range(L)]


def bench_slo(smoke: bool, chips: int = 4, req_tokens: int = 32,
              hop_alpha: float = 0.98, util: float = 0.2, seed: int = 0):
    """The acceptance scenario: a real rate/latency trade-off. Max-min
    takes every hop (3 of them at ~one stage-service each) for 4x
    saturation; the 2-partition max-min pick pays ONE hop for 2x. Under a
    mildly bursty trace the 2-chip pick's simulated tail sits strictly
    below the 4-chip pick's, while the 1-chip deployment's burst queueing
    dominates ITS tail. An SLO strictly between the two tails therefore
    binds: the rate-optimal pick is infeasible, the search walks to the
    2-chip cuts. Seeded and deterministic, so the gated inequality
    (slo p99 < max-min p99) is exact, not statistical."""
    tpu = TPUModel(chips=chips)
    # pass 1: measure the per-stage rate with negligible hop cost (stage
    # rates depend only on the workloads, not the boundary widths)
    probe = _uniform_stack(2 * chips, 1024, act=1.0)
    mm0 = partition_pipeline(probe, tpu, tpu.chip_budget, n_parts=chips,
                             batch=req_tokens, dse_iters=200,
                             objective="maxmin")
    r_stage = min(mm0.part_throughput)
    # pass 2: widen the boundaries so one hop costs hop_alpha stage-service
    # times per sample — hop rate r_stage/hop_alpha still exceeds every
    # stage rate, so max-min keeps all chips-1 cuts and its 4x rate
    per_elem = ACT_BYTES / (ICI_BW * ICI_LINKS) * tpu.freq
    act = hop_alpha / r_stage / per_elem
    layers = _uniform_stack(2 * chips, 1024, act=act)
    mm = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=chips,
                            batch=req_tokens, dse_iters=200,
                            objective="maxmin")
    one = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=1,
                             batch=req_tokens, dse_iters=200,
                             objective="sum")
    two = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=2,
                             batch=req_tokens, dse_iters=200,
                             objective="maxmin")
    n_req = 600 if smoke else 1500
    rate = request_rate(one.steady_throughput, util, req_tokens)
    trace = mmpp_trace(n_req, 0.8 * rate, 1.8 * rate,
                       dwell_base=8.0 / rate, dwell_burst=2.0 / rate,
                       sizes=req_tokens, seed=seed)
    rep_mm = simulate_partition(layers, tpu, mm, trace)
    rep_two = simulate_partition(layers, tpu, two, trace)
    # the structural fact the scenario demonstrates; the SLO target sits
    # strictly between the two tails so it must bind away from max-min
    assert rep_two.p99 < rep_mm.p99, \
        "scenario broken: the 2-chip tail no longer undercuts max-min's"
    slo = SLO(target=0.6 * rep_two.p99 + 0.4 * rep_mm.p99, quantile=99.0)
    sl = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=chips,
                            batch=req_tokens, dse_iters=200,
                            objective="slo", slo=slo, trace=trace)
    p99_slo = latency_percentile(sl.sim_report, 99.0)
    row = {"chips": chips, "hop_alpha": hop_alpha, "util": util,
           "trace": {"kind": trace.kind, "requests": len(trace),
                     "req_tokens": req_tokens},
           "slo_target": slo.target,
           "maxmin": {"cuts": mm.cuts, "steady": mm.steady_throughput,
                      "p99": rep_mm.p99, "p50": rep_mm.p50},
           "slo": {"cuts": sl.cuts, "steady": sl.steady_throughput,
                   "p99": p99_slo,
                   "p50": sl.sim_report.p50}}
    print(f"  slo: maxmin cuts={mm.cuts} steady={mm.steady_throughput:.2e} "
          f"p99={rep_mm.p99:.3e} cy | slo cuts={sl.cuts} "
          f"steady={sl.steady_throughput:.2e} p99={p99_slo:.3e} cy "
          f"(target {slo.target:.3e})")
    assert len(mm.cuts) == chips - 1, \
        "scenario broken: max-min no longer takes every hop"
    assert p99_slo < rep_mm.p99, \
        "SLO pick must beat the max-min pick on simulated p99"
    assert p99_slo <= slo.target, \
        "SLO pick must meet the (feasible-by-construction) target"
    assert sl.cuts != mm.cuts, "the SLO must bind away from the rate pick"
    return row


def bench_latency(smoke: bool, seed: int = 0):
    """Report-only: tail latency of a sparse LM deployment across traffic
    shapes and offered loads."""
    layers = _sparse_lm("qwen3-0.6b", seed, reduced=False)
    tpu = TPUModel(chips=4)
    cuts = thin_cut_points(lm_block_bounds(layers), 10)
    p = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=4,
                           batch=32, dse_iters=200, cut_points=cuts,
                           objective="maxmin")
    n_req = 300 if smoke else 1000
    utils = (0.3, 0.7) if smoke else (0.3, 0.6, 0.85)
    rows = []
    for util in utils:
        rate = request_rate(p.steady_throughput, util, 32)
        traces = {
            "poisson": poisson_trace(n_req, rate, sizes=32, seed=seed),
            "mmpp": mmpp_trace(n_req, 0.6 * rate, 3.0 * rate,
                               dwell_base=4.0 / rate,
                               dwell_burst=1.0 / rate, sizes=32, seed=seed),
            "diurnal": diurnal_trace(n_req, 0.5 * rate, 1.8 * rate,
                                     period=50.0 / rate, sizes=32,
                                     seed=seed),
        }
        for kind, tr in traces.items():
            rep = simulate_partition(layers, tpu, p, tr)
            rows.append({"trace": kind, "util": util,
                         "p50": rep.p50, "p95": rep.p95, "p99": rep.p99,
                         "achieved": rep.achieved_throughput,
                         "max_stage_util": float(rep.utilization.max()),
                         "backlog_mean": float(rep.queue_mean[0])})
            print(f"  latency qwen3 4-chip {kind:8s} util={util:.2f}: "
                  f"p50={rep.p50:.3e} p95={rep.p95:.3e} "
                  f"p99={rep.p99:.3e} cy")
    return {"cuts": p.cuts, "steady": p.steady_throughput, "rows": rows}


def run(smoke: bool = False, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    print("deployment simulator: sim-vs-analytic agreement")
    agree_rows, worst = bench_agreement(smoke)
    print("SLO-aware partition search (bursty trace)")
    slo_row = bench_slo(smoke)
    print("latency percentiles across traffic shapes")
    lat_rows = bench_latency(smoke)
    payload = {"smoke": smoke, "sim_tol": SIM_TOL,
               "agreement": agree_rows, "worst_agreement_err": worst,
               "slo": slo_row, "latency": lat_rows}
    save_json("sim_bench", payload, dev, out_dir)
    emit("sim_bench.agreement", 0.0,
         f"worst_rel_err={worst:.2e} (tol {SIM_TOL:.0e}) over "
         f"{len(agree_rows)} randomized partitions")
    emit("sim_bench.slo", 0.0,
         f"slo_p99={slo_row['slo']['p99']:.3e} < "
         f"maxmin_p99={slo_row['maxmin']['p99']:.3e} cycles")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced seeds/trace lengths for CI")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device, out_dir=args.out_dir)
