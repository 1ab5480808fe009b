"""Fleet-serving gates (DESIGN.md §14), the port's twin of
``benchmarks/fleet_bench.py``, saved as ``fleet_bench_h100.json`` (or, on
the CPU, ``<out_dir>/fleet_bench_cpu.json``):

  * ``engine`` — the calendar-queue event engine must reproduce the
    binary-heap engine **bit-identically** (every ``SimReport`` field,
    ``np.array_equal``, no tolerance) across the gated spatial and
    temporal scenarios x traffic shapes, and must be >= 10x faster on a
    >= 1M-event diurnal trace — the property that makes simulation cheap
    enough to sit inside a TPE policy search. Hard gates.
  * ``policy`` — ``autoscale_policy_search`` on a seeded bursty (MMPP)
    scenario whose peak saturates small fleets: the searched policy must
    achieve strictly lower simulated p99 than the best static replica
    count, or equal p99 at strictly lower replica-cycles. Hard gate.
    (A diurnal variant is reported alongside, ungated.)
  * ``replay`` — the winning policy's busiest replica stream replays
    through the *real* open-loop serve path: Qwen3-0.6B at its published
    width and depth in bf16 on the card, at ``reduce_config`` size on the
    CPU. The ``ServeReport`` admission/completion clocks must equal the
    timing twin's bit for bit, and the replayed tail must stay inside the
    SLO the search was scored against. Hard gate. Its gates read virtual
    clocks only, so the section is the same at either width.

The replay's wall time (milliseconds per decode step) goes under
``serve_timing``, beside the sections.

    python -m benchmarks_torch.fleet_bench [--smoke] [--device cpu --out-dir DIR]
"""
import argparse
import time

import numpy as np

from benchmarks_torch.common import (emit, replay_model, save_json,
                                     serve_timed, target)
from benchmarks_torch.dse_bench import _sparse_workload as _sparse_cnn
from benchmarks_torch.sim_bench import _sparse_lm
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.dse import partition_pipeline
from repro_torch.core.perf_model import FPGAModel, TPUModel
from repro_torch.device import resolve_device
from repro_torch.serve.fleet import open_loop_schedule
from repro_torch.sim import (diurnal_trace, mmpp_trace, poisson_trace,
                             request_rate, simulate_partition)
from repro_torch.sim.engine import _simulate_chain
from repro_torch.sim.slo import SLO, autoscale_policy_search
from repro_torch.sim.trace import Trace, backlogged_trace

_REPORT_FIELDS = ("completions", "latency", "busy", "blocked", "idle",
                  "queue_mean", "queue_max", "down")
#: payload fields that are wall-clock readings (everything else is exact)
WALL_CLOCK = ("heap_s", "calendar_s", "speedup", "serve_timing")


def _identical(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)))
               for f in _REPORT_FIELDS)


def bench_engine_identity(smoke: bool):
    """Calendar vs heap: bit-identical ``SimReport`` on every gated
    scenario (spatial chains with finite queues + backpressure, the
    temporal single-executor schedule, all traffic shapes)."""
    scenarios = []
    tpu = TPUModel(chips=3)
    lm = _sparse_lm("qwen3-0.6b", 0)
    p_lm = partition_pipeline(lm, tpu, tpu.chip_budget, n_parts=3, batch=32,
                              dse_iters=100, objective="maxmin")
    scenarios.append(("lm_spatial", lm, tpu, p_lm, None))
    cnn = _sparse_cnn(RESNET18, 1)
    fpga = FPGAModel()
    p_t = partition_pipeline(cnn, fpga, 4096.0, n_parts=3, batch=64,
                             reconfig_cycles=1e6, dse_iters=100)
    scenarios.append(("cnn_temporal", cnn, fpga, p_t, 1e6))
    n_req = 300 if smoke else 800
    rows = []
    for tag, layers, hw, part, reconfig in scenarios:
        rate = request_rate(part.steady_throughput
                            if reconfig is None else part.throughput,
                            0.5, 32)
        traces = {
            "poisson": poisson_trace(n_req, rate, sizes=32, seed=0),
            "mmpp": mmpp_trace(n_req, 0.6 * rate, 3.0 * rate,
                               dwell_base=4.0 / rate, dwell_burst=1.0 / rate,
                               sizes=32, seed=0),
            "diurnal": diurnal_trace(n_req, 0.5 * rate, 1.8 * rate,
                                     period=50.0 / rate, sizes=32, seed=0),
            "backlogged": backlogged_trace(n_req, 32),
        }
        kw = {} if reconfig is None else {"reconfig_cycles": reconfig}
        for kind, tr in traces.items():
            for q_depth in (1, 4):
                a = simulate_partition(layers, hw, part, tr, q_depth=q_depth,
                                       engine="heap", **kw)
                b = simulate_partition(layers, hw, part, tr, q_depth=q_depth,
                                       engine="calendar", **kw)
                same = _identical(a, b)
                cons = np.max(np.abs(np.asarray(a.busy) + a.blocked + a.idle
                                     - a.horizon)) / max(a.horizon, 1.0)
                rows.append({"scenario": tag, "trace": kind,
                             "q_depth": q_depth, "identical": same,
                             "conservation_rel_err": float(cons)})
                assert same, f"engine mismatch: {tag}/{kind}/q={q_depth}"
                assert cons < 1e-9, \
                    f"time conservation broken: {tag}/{kind} err={cons:.2e}"
    print(f"  engine: {len(rows)} scenario x trace x depth combos, all "
          f"SimReport fields bit-identical (heap vs calendar)")
    return rows


def engine_race(n: int):
    """One diurnal trace of ``n`` requests (2n events) through a single
    executor on both engines: ``{"events", "heap_s", "calendar_s",
    "speedup", "identical"}``. Asserts the two engines agree bit for bit;
    the speed gate is the caller's."""
    tr = diurnal_trace(n, 1e-5, 4e-5, 1e7, sizes=8, seed=0)
    rates = [1e-4, 1.3e-4]
    service = [lambda sz: sum(sz / r for r in rates) + 1e5]
    caps = [n + 1]
    t0 = time.perf_counter()
    cal = _simulate_chain(tr.arrivals, tr.sizes, service, caps,
                          engine="calendar")
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    heap = _simulate_chain(tr.arrivals, tr.sizes, service, caps,
                           engine="heap")
    t_heap = time.perf_counter() - t0
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(heap, cal))
    assert same, \
        f"calendar engine diverged from heap on the {2 * n}-event trace"
    return {"events": 2 * n, "heap_s": t_heap, "calendar_s": t_cal,
            "speedup": t_heap / t_cal, "identical": same}


def bench_engine_speedup(smoke: bool):
    """>= 10x on a >= 1M-event diurnal trace through a single executor —
    the shape a policy search simulates (temporal M=1 fast path)."""
    n = 500_000                      # 1M events (one arrival + one finish)
    race = engine_race(n)
    speedup = race["speedup"]
    print(f"  speedup: {2 * n} events, heap {race['heap_s']:.2f}s vs "
          f"calendar {race['calendar_s']:.3f}s -> {speedup:.1f}x, "
          f"bit-identical={race['identical']}")
    assert speedup >= 10.0, \
        f"calendar speedup regressed: {speedup:.1f}x < 10x"
    return {"events": 2 * n, "heap_s": race["heap_s"],
            "calendar_s": race["calendar_s"], "speedup": speedup}


def bench_policy(smoke: bool):
    """The autoscaling win: searched policy vs best static replica count
    on a bursty MMPP trace whose peaks saturate small fleets (peak rate
    ~3.5x one replica's admission capacity) and whose troughs are sparse.
    Deterministic: seeded trace, deterministic controller + TPE."""
    kw = dict(batch_slots=8, step_cycles=100.0, prefill_cycles=300.0)
    n_req = 2000 if smoke else 6000
    trials = 16 if smoke else 32
    tr = mmpp_trace(n_req, 2e-4, 1.5e-2, dwell_base=3e5, dwell_burst=8e4,
                    sizes=[8, 16], seed=0)
    pol, rep, base = autoscale_policy_search(tr, max_replicas=4,
                                             n_trials=trials, seed=0, **kw)
    p99_s, cost_s = base[base["static_best"]]
    win = (rep.p99 < p99_s) or (rep.p99 <= p99_s
                                and rep.replica_cycles < cost_s)
    print(f"  policy[mmpp]: static best R={base['static_best']} "
          f"p99={p99_s:.3e} cost={cost_s:.3e} | searched p99={rep.p99:.3e} "
          f"cost={rep.replica_cycles:.3e} "
          f"({rep.replica_cycles / cost_s:.0%} of static)")
    assert win, ("searched policy must beat the best static replica count: "
                 f"p99 {rep.p99:.3e} vs {p99_s:.3e}, cost "
                 f"{rep.replica_cycles:.3e} vs {cost_s:.3e}")
    # diurnal variant, reported ungated
    trd = diurnal_trace(n_req, 2e-5, 1.2e-2, 4e5, sizes=[8, 16], seed=0)
    pol_d, rep_d, base_d = autoscale_policy_search(
        trd, max_replicas=4, n_trials=trials, seed=0, **kw)
    p99_sd, cost_sd = base_d[base_d["static_best"]]
    print(f"  policy[diurnal]: static p99={p99_sd:.3e} cost={cost_sd:.3e} | "
          f"searched p99={rep_d.p99:.3e} cost={rep_d.replica_cycles:.3e}")
    row = {"trace": {"kind": tr.kind, "requests": len(tr)},
           "static": {str(r): {"p99": base[r][0], "cost": base[r][1]}
                      for r in range(1, 5)},
           "static_best": base["static_best"],
           "searched": {"p99": rep.p99, "cost": rep.replica_cycles,
                        "policy": {"min_replicas": pol.min_replicas,
                                   "max_replicas": pol.max_replicas,
                                   "scale_up_backlog": pol.scale_up_backlog,
                                   "scale_down_backlog":
                                       pol.scale_down_backlog,
                                   "boundary_cycles": pol.boundary_cycles,
                                   "admit_depth": pol.admit_depth}},
           "diurnal": {"static_p99": p99_sd, "static_cost": cost_sd,
                       "searched_p99": rep_d.p99,
                       "searched_cost": rep_d.replica_cycles}}
    return row, (pol, rep, tr, p99_s, kw)


def bench_replay(smoke: bool, winner, device="cuda", timing=None):
    """The winning policy's schedule is real: its busiest replica's
    request stream replays through ``ServeSession.serve_open_loop`` on
    Qwen3-0.6B (``common.replay_model``: full width in bf16 on the card).
    The real session's admission/completion clocks must equal the timing
    twin's bit for bit, and the replayed tail must stay within the SLO
    (the best static fleet's p99 — the target the search was required not
    to regress). ``timing``: see ``common.serve_timed``."""
    from repro_torch.serve.serve_loop import ServeSession, requests_from_trace

    dev = resolve_device(device)
    pol, rep, tr, p99_s, kw = winner
    n_replay = 12 if smoke else 24
    counts = np.bincount(rep.assignment, minlength=pol.max_replicas)
    busiest = int(np.argmax(counts))
    idx = np.flatnonzero(rep.assignment == busiest)[:n_replay]
    sub = Trace(rep.routed_at[idx] - rep.routed_at[idx].min(),
                tr.sizes[idx], kind=tr.kind)
    cfg, api, params = replay_model("qwen3-0.6b", dev)
    sess = ServeSession(api, params, batch_slots=kw["batch_slots"],
                        S_max=int(8 + max(sub.sizes) + 8), device=dev)
    del params                       # the session keeps its own copy
    reqs = requests_from_trace(sub, vocab_size=cfg.vocab_size,
                               prompt_len=8, seed=0)
    srep = serve_timed(sess, reqs, timing, "replay",
                       step_cycles=kw["step_cycles"],
                       prefill_cycles=kw["prefill_cycles"])
    adm, comp = open_loop_schedule(sub.arrivals, sub.sizes,
                                   batch_slots=kw["batch_slots"],
                                   step_cycles=kw["step_cycles"],
                                   prefill_cycles=kw["prefill_cycles"])
    twin = (np.array_equal(srep.admissions, adm)
            and np.array_equal(srep.completions, comp))
    slo = SLO(target=float(p99_s), quantile=99.0)
    print(f"  replay: replica {busiest}, {len(idx)} requests through the "
          f"real serve path ({cfg.name}, {cfg.num_layers} layers x "
          f"{cfg.d_model}, {cfg.dtype}, {dev}): twin-identical={twin}, "
          f"p99={srep.p99:.3e} (SLO {slo.target:.3e})")
    assert twin, "real serve path diverged from the fleet timing twin"
    assert srep.p99 <= slo.target, \
        f"replayed p99 {srep.p99:.3e} violates the SLO {slo.target:.3e}"
    return {"replica": busiest, "requests": len(idx),
            "twin_identical": twin, "p99": srep.p99,
            "slo_target": slo.target,
            "decode_steps": srep.decode_steps, "prefills": srep.prefills}


def run(smoke: bool = False, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    print("fleet serving: calendar-queue engine identity (heap reference)")
    engine_rows = bench_engine_identity(smoke)
    print("calendar-queue speedup on a 1M-event diurnal trace")
    speed_row = bench_engine_speedup(smoke)
    print("autoscale policy search vs static fleets")
    policy_row, winner = bench_policy(smoke)
    print("winning policy through the real open-loop serve path")
    timing = {}
    replay_row = bench_replay(smoke, winner, dev, timing)
    payload = {"smoke": smoke, "engine_identity": engine_rows,
               "engine_speedup": speed_row, "policy": policy_row,
               "replay": replay_row, "serve_timing": timing}
    save_json("fleet_bench", payload, dev, out_dir)
    emit("fleet_bench.engine", 0.0,
         f"bit-identical over {len(engine_rows)} combos; "
         f"{speed_row['speedup']:.1f}x on {speed_row['events']} events")
    emit("fleet_bench.policy", 0.0,
         f"searched p99={policy_row['searched']['p99']:.3e} at "
         f"{policy_row['searched']['cost'] / policy_row['static'][str(policy_row['static_best'])]['cost']:.0%}"
         f" of the best static fleet's replica-cycles")
    emit("fleet_bench.replay", 0.0,
         f"twin-identical, p99={replay_row['p99']:.3e} <= "
         f"SLO {replay_row['slo_target']:.3e}")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced trace lengths / trial counts for CI")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device, out_dir=args.out_dir)
