"""Chaos & graceful-degradation gates (DESIGN.md §17), the port's twin of
``benchmarks/chaos_bench.py``, saved as ``chaos_bench_h100.json`` (or, on
the CPU, ``<out_dir>/chaos_bench_cpu.json``):

  * ``zero_fault`` — consuming the explicit no-op scenario
    (``FaultTrace.none()``) must be **bit-identical** to ``faults=None``
    on every consumer: ``SimReport`` (temporal + spatial chains),
    ``FleetReport`` (full per-request arrays + replica-cycles), and the
    real serve path's ``ServeReport`` transcript with the chaos kwargs at
    their defaults (two runs of one session: the same clocks and the same
    tokens). Hard gate — the fault layer may not perturb a single bit of
    the pre-fault contracts.
  * ``engine`` — heap vs calendar stay bit-identical *under* faults
    (crash windows, stragglers, ICI degradation) and the extended
    conservation law ``busy + blocked + idle + down == horizon`` holds
    per node. Hard gate.
  * ``search`` — one replica crashes at the MMPP peak: the
    failure-aware ``autoscale_policy_search`` (simulating its trials
    under the fault set) must find a policy with strictly lower simulated
    p99 under that fault than the fault-blind search's winner. Hard gate.
  * ``degrade`` — same crash, deadline-bound traffic: a
    ``DegradationPolicy`` stepping down the sparsity frontier must shed
    strictly fewer requests than the non-degrading fleet at no extra
    replica cost. Hard gate.
  * ``replay`` — a frontier-degraded bucket schedule (rung step-scales
    priced by ``core.dse.degradation_ladder``, deadlines attached)
    replays **twin-identical** through the real
    ``ServeSession.serve_open_loop``. Hard gate.

The real serve path (``zero_fault`` and ``replay``) runs Qwen3-0.6B at its
published width and depth in bf16 on the card and at ``reduce_config`` size
on the CPU (``common.replay_model``); its gates read virtual clocks and
compare a session with itself, so both sections are the same at either
width. Their wall times go under ``serve_timing``.

    python -m benchmarks_torch.chaos_bench [--smoke] [--device cpu --out-dir DIR]
"""
import argparse

import numpy as np

from benchmarks_torch.common import (emit, replay_model, save_json,
                                     serve_timed, target)
from benchmarks_torch.dse_bench import _sparse_workload as _sparse_cnn
from benchmarks_torch.sim_bench import _sparse_lm
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.dse import degradation_ladder, partition_pipeline
from repro_torch.core.perf_model import FPGAModel, TPUModel
from repro_torch.device import resolve_device
from repro_torch.serve.fleet import (AutoscalePolicy, DegradationPolicy,
                                     open_loop_schedule, simulate_fleet)
from repro_torch.sim import (inject_faults, mmpp_trace, replica_loss,
                             request_rate, simulate_partition,
                             zero_fault_trace)
from repro_torch.sim.engine import _simulate_chain
from repro_torch.sim.faults import NodeFaults
from repro_torch.sim.slo import autoscale_policy_search

_SIM_FIELDS = ("completions", "latency", "busy", "blocked", "idle",
               "queue_mean", "queue_max", "down")
_FLEET_FIELDS = ("admissions", "completions", "latency", "assignment",
                 "routed_at", "shed_mask", "retries")
_FLEET_KW = dict(batch_slots=8, step_cycles=100.0, prefill_cycles=300.0)
#: payload fields that are wall-clock readings (everything else is exact)
WALL_CLOCK = ("serve_timing",)


def _identical(a, b, fields) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)))
               for f in fields)


def bench_zero_fault(smoke: bool, device="cuda", timing=None):
    """``FaultTrace.none()`` == ``faults=None``, byte for byte, on every
    consumer — the regression gate that pins the pre-fault code paths.
    ``timing``: see ``common.serve_timed``."""
    rows = []
    # SimReport: temporal (FPGA) and spatial (TPU slice) chains
    tpu = TPUModel(chips=3)
    lm = _sparse_lm("qwen3-0.6b", 0)
    p_lm = partition_pipeline(lm, tpu, tpu.chip_budget, n_parts=3, batch=32,
                              dse_iters=100, objective="maxmin")
    cnn = _sparse_cnn(RESNET18, 1)
    fpga = FPGAModel()
    p_t = partition_pipeline(cnn, fpga, 4096.0, n_parts=3, batch=64,
                             reconfig_cycles=1e6, dse_iters=100)
    n_req = 300 if smoke else 800
    for tag, layers, hw, part, kw in (
            ("lm_spatial", lm, tpu, p_lm, {}),
            ("cnn_temporal", cnn, fpga, p_t, {"reconfig_cycles": 1e6})):
        rate = request_rate(part.steady_throughput if tag == "lm_spatial"
                            else part.throughput, 0.5, 32)
        tr = mmpp_trace(n_req, 0.6 * rate, 3.0 * rate,
                        dwell_base=4.0 / rate, dwell_burst=1.0 / rate,
                        sizes=32, seed=0)
        for eng in ("heap", "calendar"):
            ref = simulate_partition(layers, hw, part, tr, engine=eng, **kw)
            got = simulate_partition(layers, hw, part, tr, engine=eng,
                                     faults=zero_fault_trace(), **kw)
            same = _identical(ref, got, _SIM_FIELDS)
            rows.append({"consumer": f"sim/{tag}/{eng}", "identical": same})
            assert same, f"zero-fault perturbed SimReport: {tag}/{eng}"
    # FleetReport
    trf = mmpp_trace(1500 if smoke else 4000, 2e-4, 1.5e-2, dwell_base=3e5,
                     dwell_burst=8e4, sizes=[8, 16], seed=0)
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3,
                          scale_up_backlog=1.0, scale_down_backlog=0.2)
    ref = simulate_fleet(trf, pol, **_FLEET_KW)
    got = simulate_fleet(trf, pol, faults=zero_fault_trace(), **_FLEET_KW)
    same = _identical(ref, got, _FLEET_FIELDS) \
        and got.replica_cycles == ref.replica_cycles \
        and got.timeline == ref.timeline
    rows.append({"consumer": "fleet", "identical": same})
    assert same, "zero-fault scenario perturbed the FleetReport"
    # real serve transcript: chaos kwargs at defaults change nothing
    from repro_torch.serve.serve_loop import ServeSession, requests_from_trace
    from repro_torch.sim.trace import Trace
    dev = resolve_device(device)
    cfg, api, params = replay_model("qwen3-0.6b", dev)
    sess = ServeSession(api, params, batch_slots=4, S_max=40, device=dev)
    del params                       # the session keeps its own copy
    sub = Trace(trf.arrivals[:12] - trf.arrivals[0], trf.sizes[:12],
                kind=trf.kind)
    reqs_a = requests_from_trace(sub, vocab_size=cfg.vocab_size,
                                 prompt_len=8, seed=0)
    reqs_b = requests_from_trace(sub, vocab_size=cfg.vocab_size,
                                 prompt_len=8, seed=0)
    ra = serve_timed(sess, reqs_a, timing, "zero_fault",
                     step_cycles=100.0, prefill_cycles=300.0)
    rb = sess.serve_open_loop(reqs_b, step_cycles=100.0,
                              prefill_cycles=300.0, step_schedule=None,
                              switch_cycles=0.0)
    same = (np.array_equal(ra.admissions, rb.admissions)
            and np.array_equal(ra.completions, rb.completions)
            and ra.outputs == rb.outputs and rb.shed == 0)
    rows.append({"consumer": "serve", "identical": same})
    assert same, "chaos kwargs at defaults perturbed the serve transcript"
    print(f"  zero_fault: {len(rows)} consumers bit-identical to "
          f"faults=None")
    return rows


def bench_faulted_engines(smoke: bool):
    """Heap vs calendar under injected faults: bit-identical reports and
    ``busy + blocked + idle + down == horizon`` per node."""
    rng = np.random.default_rng(0)
    trials = 8 if smoke else 20
    rows = []
    for trial in range(trials):
        m = int(rng.integers(1, 5))
        n = int(rng.integers(60, 160))
        arr = np.sort(rng.uniform(0, 5e4, n))
        sizes = rng.integers(1, 16, n).astype(np.int64)
        rates = rng.uniform(5e-3, 5e-2, m)
        service = [(lambda r: (lambda s: s / r))(r) for r in rates]
        caps = [10 ** 9] + [int(rng.integers(1, 4)) for _ in range(m - 1)]
        ft = inject_faults(m, 6e4, crash_rate=3e-4, restart_mean=2e3,
                           slow_rate=3e-4, slow_mean=3e3, slow_factor=0.5,
                           seed=trial)
        fx = NodeFaults(down=[ft.down_windows(u) for u in range(m)],
                        slow=[ft.slow_windows(u) for u in range(m)])
        heap = _simulate_chain(arr, sizes, service, caps, "heap", fx)
        cal = _simulate_chain(arr, sizes, service, caps, "calendar", fx)
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(heap, cal))
        comp, busy, blocked, idle, _, _, down = heap
        horizon = comp.max()
        cons = max(abs(busy[k] + blocked[k] + idle[k] + down[k] - horizon)
                   for k in range(m)) / max(horizon, 1.0)
        rows.append({"trial": trial, "nodes": m, "identical": same,
                     "down_cycles": float(sum(down)),
                     "conservation_rel_err": float(cons)})
        assert same, f"faulted engines diverged on trial {trial}"
        assert cons < 1e-9, f"conservation broken under faults: {cons:.2e}"
    fired = sum(1 for r in rows if r["down_cycles"] > 0)
    print(f"  engine: {trials} faulted chains bit-identical "
          f"(heap vs calendar), down>0 in {fired}, conservation holds")
    assert fired > 0, "fault set never displaced any cycles"
    return rows


def _crash_scenario(smoke: bool):
    n_req = 2500 if smoke else 6000
    tr = mmpp_trace(n_req, 2e-4, 1.5e-2, dwell_base=3e5, dwell_burst=8e4,
                    sizes=[8, 16], seed=0)
    peak = float(np.median(tr.arrivals))
    return tr, replica_loss(0, peak, peak + 1.5e6)


def bench_failure_aware_search(smoke: bool):
    """One replica lost at the MMPP peak: searching *under* the fault set
    must beat searching blind, measured under that same fault."""
    tr, ft = _crash_scenario(smoke)
    trials = 16 if smoke else 32
    chaos = dict(faults=ft, deadline_cycles=4e5)
    pol_b, _, _ = autoscale_policy_search(tr, max_replicas=3,
                                          n_trials=trials, seed=0,
                                          **_FLEET_KW)
    pol_a, rep_a, base = autoscale_policy_search(tr, max_replicas=3,
                                                 n_trials=trials, seed=0,
                                                 **chaos, **_FLEET_KW)
    rep_b = simulate_fleet(tr, pol_b, **chaos, **_FLEET_KW)
    p99_b = rep_b.p99 if rep_b.completed else float("inf")
    p99_a = rep_a.p99 if rep_a.completed else float("inf")
    print(f"  search: fault-blind winner under crash p99={p99_b:.4e} "
          f"shed={rep_b.shed} | failure-aware p99={p99_a:.4e} "
          f"shed={rep_a.shed}")
    assert p99_a < p99_b, \
        (f"failure-aware search must strictly beat the fault-blind pick "
         f"under the fault set: {p99_a:.4e} vs {p99_b:.4e}")
    assert rep_a.shed <= rep_b.shed
    return {"blind_p99": p99_b, "blind_shed": int(rep_b.shed),
            "aware_p99": p99_a, "aware_shed": int(rep_a.shed),
            "static_best": base["static_best"],
            "aware_policy": {"min_replicas": pol_a.min_replicas,
                             "scale_up_backlog": pol_a.scale_up_backlog}}


def bench_degradation(smoke: bool):
    """Deadline-bound traffic through the crash: stepping down the
    frontier ladder must shed strictly fewer requests at no extra
    replica cost."""
    n_req = 2000 if smoke else 5000
    tr = mmpp_trace(n_req, 2e-4, 2e-2, dwell_base=2e5, dwell_burst=1.5e5,
                    sizes=[8, 16], seed=0)
    peak = float(np.median(tr.arrivals))
    ft = replica_loss(1, peak, peak + 2e6)
    kw = dict(faults=ft, deadline_cycles=2e5, **_FLEET_KW)
    plain = simulate_fleet(tr, AutoscalePolicy.static(2), **kw)
    deg = DegradationPolicy(ladder=(1.0, 0.6, 0.35), degrade_backlog=3.0,
                            recover_backlog=0.5, dwell_cycles=1e5,
                            switch_cycles=1e4)
    soft = simulate_fleet(tr, AutoscalePolicy.static(2), degradation=deg,
                          **kw)
    moves = len(soft.rung_timeline) - 1
    print(f"  degrade: plain shed={plain.shed} vs degraded "
          f"shed={soft.shed} ({moves} rung moves), cost "
          f"{soft.replica_cycles:.3e} vs {plain.replica_cycles:.3e}")
    assert soft.shed < plain.shed, \
        f"degradation must shed fewer: {soft.shed} vs {plain.shed}"
    assert soft.replica_cycles <= plain.replica_cycles * (1 + 1e-9), \
        "degradation must not cost extra replica-cycles"
    return {"plain_shed": int(plain.shed), "degraded_shed": int(soft.shed),
            "rung_moves": moves,
            "plain_cost": plain.replica_cycles,
            "degraded_cost": soft.replica_cycles,
            "rung_timeline": [(float(a), int(b))
                              for a, b in soft.rung_timeline]}


def bench_degraded_replay(smoke: bool, device="cuda", timing=None):
    """A frontier-degraded schedule is real: rung step-scales priced by
    ``degradation_ladder`` on a sparse CNN stack become a
    ``step_schedule``, and the degraded, deadline-bound bucket schedule
    replays twin-identical through the real serve path.
    ``timing``: see ``common.serve_timed``."""
    from repro_torch.serve.serve_loop import Request, ServeSession

    dev = resolve_device(device)

    rungs = degradation_ladder(_sparse_cnn(RESNET18, 1), FPGAModel(),
                               budget=4096.0, s_extra=(0.0, 0.2, 0.4))
    ladder = tuple(r.step_scale for r in rungs)
    cfg, api, params = replay_model("qwen3-0.6b", dev)
    sess = ServeSession(api, params, batch_slots=4, S_max=40, device=dev)
    del params                       # the session keeps its own copy
    rng = np.random.default_rng(5)
    n = 16 if smoke else 32
    arr = np.cumsum(rng.exponential(400.0, n)).astype(float)
    new = rng.integers(4, 20, n).astype(float)
    dls = arr + rng.uniform(2e3, 2e4, n)
    # degrade two rungs down mid-trace, recover near the end
    sched = [(0.0, ladder[0]), (float(arr[n // 3]), ladder[1]),
             (float(arr[n // 2]), ladder[2]), (float(arr[-3]), ladder[0])]
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=6),
                    max_new=int(new[i]), arrival=float(arr[i]),
                    deadline=float(dls[i])) for i in range(n)]
    rep = serve_timed(sess, reqs, timing, "replay", step_cycles=60.0,
                      prefill_cycles=180.0, step_schedule=sched,
                      switch_cycles=90.0)
    adm, comp = open_loop_schedule(arr, new, batch_slots=sess.B,
                                   step_cycles=60.0, prefill_cycles=180.0,
                                   deadlines=dls, step_schedule=sched,
                                   switch_cycles=90.0)
    twin = (np.array_equal(rep.admissions, adm)
            and np.array_equal(rep.completions, comp))
    print(f"  replay: {n} requests, ladder={tuple(round(s, 3) for s in ladder)}, "
          f"shed={rep.shed}, switch_stalls={rep.switch_stalls}, "
          f"twin-identical={twin}")
    assert twin, "degraded schedule diverged from the real serve path"
    assert rep.switch_stalls > 0, "the rung schedule never actually moved"
    return {"requests": n, "ladder": list(ladder), "shed": int(rep.shed),
            "switch_stalls": int(rep.switch_stalls),
            "twin_identical": twin}


def run(smoke: bool = False, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    timing = {}
    print("chaos: zero-fault scenarios bit-identical to faults=None")
    zero_rows = bench_zero_fault(smoke, dev, timing)
    print("chaos: engine bit-identity + conservation under faults")
    engine_rows = bench_faulted_engines(smoke)
    print("chaos: failure-aware vs fault-blind autoscale search")
    search_row = bench_failure_aware_search(smoke)
    print("chaos: graceful degradation vs hard shedding")
    degrade_row = bench_degradation(smoke)
    print("chaos: degraded schedule through the real serve path")
    replay_row = bench_degraded_replay(smoke, dev, timing)
    payload = {"smoke": smoke, "zero_fault": zero_rows,
               "engine": engine_rows, "search": search_row,
               "degrade": degrade_row, "replay": replay_row,
               "serve_timing": timing}
    save_json("chaos_bench", payload, dev, out_dir)
    emit("chaos_bench.zero_fault", 0.0,
         f"{len(zero_rows)} consumers bit-identical")
    emit("chaos_bench.engine", 0.0,
         f"{len(engine_rows)} faulted chains bit-identical, "
         f"conservation holds")
    emit("chaos_bench.search", 0.0,
         f"failure-aware p99={search_row['aware_p99']:.3e} < "
         f"fault-blind {search_row['blind_p99']:.3e} under crash")
    emit("chaos_bench.degrade", 0.0,
         f"shed {degrade_row['degraded_shed']} vs "
         f"{degrade_row['plain_shed']} at no extra cost")
    emit("chaos_bench.replay", 0.0,
         f"twin-identical, {replay_row['switch_stalls']} rung stalls, "
         f"{replay_row['shed']} shed")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced trace lengths / trial counts for CI")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device, out_dir=args.out_dir)
