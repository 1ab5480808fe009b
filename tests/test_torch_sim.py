"""repro_torch's deployment simulator, fault injection and SLO search against
the JAX package's (all numpy in both packages).

Twins of ``test_sim.py``'s engine and SLO tests and of ``test_faults.py``:
each builds the same layer stack, trace and fault scenario in both packages
from one seed, asserts that the two packages' results are equal field for
field (``SimReport``, ``FleetReport``, ``PartitionResult``, policies —
bit-identical, as pure numpy code must be), and keeps the reference test's
own properties on the port's result: saturation within ``SIM_TOL`` of the
analytic rate, the calendar engine equal to the heap engine, time
conservation, shed accounting.
"""
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs, sim as jsim
from repro.core import dse as jdse, hass as jhass, perf_model as jpm
from repro.serve import fleet as jfleet
from repro.sim import engine as jengine, faults as jfaults, slo as jslo
from repro_torch import configs as tconfigs, sim as tsim
from repro_torch.core import dse as tdse, hass as thass, perf_model as tpm
from repro_torch.serve import fleet as tfleet
from repro_torch.sim import engine as tengine, faults as tfaults, slo as tslo
from test_torch_core import _as_plain

J = SimpleNamespace(configs=jconfigs, pm=jpm, dse=jdse, hass=jhass,
                    sim=jsim, engine=jengine, faults=jfaults, slo=jslo,
                    fleet=jfleet)
T = SimpleNamespace(configs=tconfigs, pm=tpm, dse=tdse, hass=thass,
                    sim=tsim, engine=tengine, faults=tfaults, slo=tslo,
                    fleet=tfleet)
KW = dict(batch_slots=4, step_cycles=10.0, prefill_cycles=30.0)
_CHAIN_FIELDS = ("completions", "busy", "blocked", "idle",
                 "queue_mean", "queue_max", "down")


def both(fn):
    """``fn(J)`` and ``fn(T)`` must be equal field for field; returns the
    port's result."""
    j, t = fn(J), fn(T)
    assert _as_plain(j) == _as_plain(t)
    return t


def cnn_stack(s, arch: str, seed: int = 1):
    """``conftest.sparse_cnn_workload`` for either package."""
    rng = np.random.default_rng(seed)
    layers = s.pm.cnn_layer_costs(s.configs.get_config(arch))
    for l in layers:
        l.s_w = float(rng.uniform(0.1, 0.8))
        l.s_a = float(rng.uniform(0.1, 0.6))
        l.s_w_tile = float(rng.uniform(0.0, 0.4))
    return layers


def lm_stack(s, arch: str, seed: int):
    """``test_sim._sparse_lm_stack`` for either package."""
    layers = s.pm.lm_layer_costs(s.configs.reduce_config(
        s.configs.get_config(arch)), seq_len=64)
    rng = np.random.default_rng(seed)
    for l in layers:
        if l.prunable:
            l.s_w = l.s_w_tile = float(rng.uniform(0.0, 0.8))
    return layers


def tpu_partition(s, layers, chips, batch, objective="sum", dse_iters=80,
                  **kw):
    tpu = s.pm.TPUModel(chips=chips, **kw)
    return tpu, s.dse.partition_pipeline(
        layers, tpu, tpu.chip_budget, n_parts=chips, batch=batch,
        dse_iters=dse_iters, objective=objective)


# --------------------------------------------------------------------- #
# Sim-vs-analytic saturation contract
# --------------------------------------------------------------------- #
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10 ** 6), chips=st.integers(2, 4),
       objective=st.sampled_from(["sum", "maxmin"]),
       workload=st.sampled_from(["cnn", "lm"]))
def test_property_spatial_saturation_matches_steady_throughput(
        seed, chips, objective, workload):
    def run(s):
        if workload == "cnn":
            layers, cut_points = cnn_stack(s, "mobilenetv3s", seed), None
        else:
            layers = lm_stack(s, "qwen3-0.6b", seed)
            cut_points = s.pm.lm_block_bounds(layers)
        tpu = s.pm.TPUModel(chips=chips)
        p = s.dse.partition_pipeline(layers, tpu, tpu.chip_budget,
                                     n_parts=chips, batch=32, dse_iters=80,
                                     objective=objective,
                                     cut_points=cut_points)
        return p, s.sim.saturation_throughput(layers, tpu, p, n_requests=64)
    p, sat = both(run)
    assert sat == pytest.approx(p.steady_throughput, rel=tsim.SIM_TOL)


def test_spatial_saturation_matches_on_heterogeneous_chips():
    def run(s):
        layers = cnn_stack(s, "resnet18", 3)
        tpu, p = tpu_partition(s, layers, 3, 32, "maxmin",
                               chip_lanes=(512.0, 256.0, 384.0))
        return p, s.sim.saturation_throughput(layers, tpu, p, n_requests=64)
    p, sat = both(run)
    assert sat == pytest.approx(p.steady_throughput, rel=tsim.SIM_TOL)


@pytest.mark.parametrize("n_parts", [1, 3])
def test_temporal_saturation_matches_amortized_throughput(n_parts):
    def run(s):
        layers = cnn_stack(s, "resnet18", 1)
        hw = s.pm.FPGAModel()
        p = s.dse.partition_pipeline(layers, hw, 4096.0, n_parts=n_parts,
                                     batch=64, reconfig_cycles=1e6,
                                     dse_iters=100)
        return p, s.sim.saturation_throughput(layers, hw, p,
                                              reconfig_cycles=1e6)
    p, sat = both(run)
    assert sat == pytest.approx(p.throughput, rel=tsim.SIM_TOL)


def test_temporal_mode_forced_on_multichip_uses_ici_switches():
    def run(s):
        layers = cnn_stack(s, "resnet18", 2)
        tpu, p = tpu_partition(s, layers, 3, 64, "sum")
        return p, s.sim.saturation_throughput(layers, tpu, p,
                                              mode="temporal")
    p, sat = both(run)
    assert sat == pytest.approx(p.throughput, rel=tsim.SIM_TOL)


# --------------------------------------------------------------------- #
# Switch stalls, backpressure, latency invariants
# --------------------------------------------------------------------- #
def test_single_resident_partition_incurs_zero_switch_stalls():
    def run(s):
        layers = cnn_stack(s, "resnet18", 1)[:8]
        hw = s.pm.FPGAModel()
        p1 = s.dse.partition_pipeline(layers, hw, 256.0, n_parts=1,
                                      batch=32, reconfig_cycles=1e12,
                                      dse_iters=60)
        return p1, s.sim.simulate_partition(
            layers, hw, p1, s.sim.poisson_trace(100, 1e-6, sizes=32, seed=0),
            reconfig_cycles=1e12)
    p1, rep = both(run)
    assert p1.cuts == []
    assert rep.switch_stalls == 0 and rep.switch_stall_cycles == 0.0


def test_temporal_switch_stalls_are_p_minus_1_per_request():
    n = 40

    def run(s):
        layers = cnn_stack(s, "resnet18", 1)
        hw = s.pm.FPGAModel()
        p = s.dse.partition_pipeline(layers, hw, 4096.0, n_parts=3,
                                     batch=32, reconfig_cycles=1e6,
                                     dse_iters=80)
        return p, s.sim.simulate_partition(
            layers, hw, p, s.sim.backlogged_trace(n, 32),
            reconfig_cycles=1e6)
    p, rep = both(run)
    assert len(p.cuts) >= 1
    assert rep.switch_stalls == len(p.cuts) * n
    assert rep.switch_stall_cycles == pytest.approx(len(p.cuts) * 1e6 * n,
                                                    rel=1e-12)


def test_backpressure_respects_queue_depth():
    def run(s):
        layers = cnn_stack(s, "resnet18", 4)
        tpu, p = tpu_partition(s, layers, 4, 32)
        return [s.sim.simulate_partition(layers, tpu, p,
                                         s.sim.backlogged_trace(60, 32),
                                         q_depth=q) for q in (1, 4)]
    for q_depth, rep in zip((1, 4), both(run)):
        assert rep.mode == "spatial"
        assert max(rep.queue_max[1:]) <= q_depth
        assert rep.queue_max[0] > q_depth
    layers = cnn_stack(T, "resnet18", 4)
    tpu, p = tpu_partition(T, layers, 4, 32)
    with pytest.raises(ValueError, match="q_depth"):
        tsim.simulate_partition(layers, tpu, p, tsim.backlogged_trace(4, 32),
                                q_depth=0)


def test_latency_bounded_below_by_no_wait_service_path():
    def run(s):
        layers = cnn_stack(s, "mobilenetv3s", 5)
        tpu, p = tpu_partition(s, layers, 3, 16)
        tr = s.sim.poisson_trace(
            200, s.sim.request_rate(p.steady_throughput, 0.4, 16), sizes=16,
            seed=0)
        return p, tr.arrivals, s.sim.simulate_partition(layers, tpu, p, tr)
    p, arrivals, rep = both(run)
    base = sum(16 / r for r in p.part_throughput)
    assert rep.latency.min() >= base * (1 - 1e-12)
    assert rep.completed == len(arrivals)
    assert np.all(rep.completions > rep.arrivals)


def test_latency_percentiles_monotone_in_load():
    def run(s):
        layers = cnn_stack(s, "resnet18", 6)
        tpu, p = tpu_partition(s, layers, 2, 16)
        rate = s.sim.request_rate(p.steady_throughput, 0.3, 16)
        tr = s.sim.mmpp_trace(400, 0.6 * rate, 3 * rate,
                              dwell_base=4 / rate, dwell_burst=1 / rate,
                              sizes=16, seed=0)
        return (s.sim.simulate_partition(layers, tpu, p, tr),
                s.sim.simulate_partition(layers, tpu, p, tr.scaled(2.5)))
    lo, hi = both(run)
    assert lo.p50 <= lo.p95 <= lo.p99
    assert hi.p99 >= lo.p99
    assert hi.queue_mean[0] >= lo.queue_mean[0]


def test_report_utilization_and_throughput_sanity():
    def run(s):
        layers = cnn_stack(s, "resnet18", 7)
        tpu, p = tpu_partition(s, layers, 3, 16)
        return p, [s.sim.simulate_partition(layers, tpu, p,
                                            s.sim.backlogged_trace(n, 16))
                   for n in (64, 1)]
    p, (rep, one_req) = both(run)
    assert np.all(rep.utilization <= 1.0 + 1e-12)
    assert rep.utilization.max() > 0.95
    assert rep.achieved_throughput <= p.steady_throughput * (1 + 1e-9)
    assert rep.windowed_throughput() >= rep.achieved_throughput
    assert one_req.windowed_throughput() == one_req.achieved_throughput
    assert np.isfinite(one_req.windowed_throughput())


# --------------------------------------------------------------------- #
# Calendar-queue engine: bit-identity with the heap engine + conservation
# --------------------------------------------------------------------- #
def _fuzz_trace(s, kind: str, n: int, seed: int):
    if kind == "poisson":
        return s.sim.poisson_trace(n, 2e-6, sizes=[4, 8, 16], seed=seed)
    if kind == "backlogged":
        return s.sim.backlogged_trace(n, 8)
    if kind == "mmpp":
        return s.sim.mmpp_trace(n, 1e-6, 5e-6, dwell_base=1e7,
                                dwell_burst=2e6, sizes=8, seed=seed)
    return s.sim.diurnal_trace(n, 1e-6, 4e-6, 1e8, sizes=8, seed=seed)


def _chain(s, kind, seed, m, n, q_depth, engine):
    rng = np.random.default_rng(seed)
    tr = _fuzz_trace(s, kind, n, seed)
    service = [lambda sz, f=float(rng.uniform(5e4, 5e5)): sz * f + 1e3
               for _ in range(m)]
    caps = [len(tr) + 1] + [q_depth] * (m - 1)
    return s.engine._simulate_chain(tr.arrivals, tr.sizes, service, caps,
                                    engine=engine)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10 ** 6),
       kind=st.sampled_from(["poisson", "backlogged", "mmpp", "diurnal"]),
       m=st.integers(1, 4), q_depth=st.integers(1, 5))
def test_property_calendar_engine_bit_identical_to_heap(seed, kind, m,
                                                        q_depth):
    a = both(lambda s: _chain(s, kind, seed, m, 150, q_depth, "heap"))
    b = both(lambda s: _chain(s, kind, seed, m, 150, q_depth, "calendar"))
    for name, x, y in zip(_CHAIN_FIELDS, a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10 ** 6),
       kind=st.sampled_from(["poisson", "backlogged", "mmpp", "diurnal"]),
       m=st.integers(1, 4),
       engine=st.sampled_from(["heap", "calendar"]))
def test_property_time_conservation_busy_blocked_idle(seed, kind, m,
                                                      engine):
    completions, busy, blocked, idle, _, _, _ = both(
        lambda s: _chain(s, kind, seed, m, 120, 1, engine))
    horizon = float(np.max(completions))
    total = np.asarray(busy) + np.asarray(blocked) + np.asarray(idle)
    assert np.allclose(total, horizon, rtol=1e-9, atol=1e-6)
    if m > 1:
        assert np.asarray(blocked)[:-1].sum() >= 0.0
        assert np.asarray(idle).min() >= 0.0


def test_simulate_partition_engine_parameter_and_idle_field():
    def run(s):
        layers = cnn_stack(s, "resnet18", 9)
        tpu, p = tpu_partition(s, layers, 3, 16)
        tr = s.sim.poisson_trace(
            120, s.sim.request_rate(p.steady_throughput, 0.5, 16), sizes=16,
            seed=0)
        return [s.sim.simulate_partition(layers, tpu, p, tr, engine=e)
                for e in ("heap", "calendar")]
    a, b = both(run)
    assert _as_plain(a) == _as_plain(b)
    assert np.allclose(a.busy + a.blocked + a.idle, a.horizon, rtol=1e-9)
    layers = cnn_stack(T, "resnet18", 9)
    tpu, p = tpu_partition(T, layers, 3, 16)
    with pytest.raises(ValueError, match="engine"):
        tsim.simulate_partition(layers, tpu, p, tsim.backlogged_trace(4, 16),
                                engine="quantum")


# --------------------------------------------------------------------- #
# SLO-aware partition search
# --------------------------------------------------------------------- #
def _slo_setup(s, seed=0):
    layers = cnn_stack(s, "resnet18", seed)
    tpu, mm = tpu_partition(s, layers, 4, 16, "maxmin")
    rate = s.sim.request_rate(mm.steady_throughput, 0.4, 16)
    tr = s.sim.mmpp_trace(250, 0.6 * rate, 3 * rate, dwell_base=4 / rate,
                          dwell_burst=1 / rate, sizes=16, seed=seed)
    return layers, tpu, mm, tr


def test_slo_objective_reduces_to_maxmin_when_slack():
    def run(s):
        layers, tpu, mm, tr = _slo_setup(s)
        rep = s.sim.simulate_partition(layers, tpu, mm, tr)
        r = s.dse.partition_pipeline(
            layers, tpu, tpu.chip_budget, n_parts=4, batch=16, dse_iters=80,
            objective="slo", slo=s.sim.SLO(target=rep.p99 * 100.0), trace=tr)
        return mm, rep, r
    mm, rep, r = both(run)
    assert r.objective == "slo" and r.cuts == mm.cuts
    assert r.sim_report is not None
    assert tslo.latency_percentile(r.sim_report, 99.0) <= rep.p99 * 100.0


def test_slo_objective_returns_least_violating_when_impossible():
    def run(s):
        layers, tpu, mm, tr = _slo_setup(s, seed=1)
        return s.slo.slo_partition_search(
            layers, tpu, tpu.chip_budget, slo=s.sim.SLO(target=1.0),
            trace=tr, n_parts=4, batch=16, dse_iters=80)
    r = both(run)
    assert r.objective == "slo" and r.sim_report is not None
    assert tslo.latency_percentile(r.sim_report, 99.0) > 1.0


def test_slo_objective_validation():
    layers, tpu, mm, tr = _slo_setup(T, seed=2)
    with pytest.raises(ValueError, match="trace"):
        tdse.partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=2,
                                objective="slo", slo=tsim.SLO(target=1e9))
    with pytest.raises(ValueError, match="slo"):
        tdse.partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=2,
                                objective="slo", trace=tr)
    with pytest.raises(ValueError, match="slo"):
        tdse.partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=2,
                                objective="maxmin", trace=tr, dse_iters=60)

    def run(s):            # a bare float is accepted as a p99 target
        layers, tpu, _, tr = _slo_setup(s, seed=2)
        return s.dse.partition_pipeline(
            layers, tpu, tpu.chip_budget, n_parts=2, batch=16, dse_iters=80,
            objective="slo", slo=1e30, trace=tr)
    assert both(run).objective == "slo"


# --------------------------------------------------------------------- #
# Search + serving integration
# --------------------------------------------------------------------- #
def test_hass_search_scores_the_lat_term():
    m0 = {"acc": 0.8, "spa": 0.5, "thr": 10.0, "thr_norm": 0.4,
          "dsp": 0.6, "lat": 2.0}

    def run(s):
        return [s.hass.hass_search(lambda x: dict(m0), 3, iters=2, seed=0,
                                   lambdas=s.hass.Lambdas(lat=lat)).best_score
                for lat in (0.25, 0.0)]
    scored, plain = both(run)
    lam = thass.Lambdas()
    want = m0["acc"] + lam.spa * m0["spa"]
    want += lam.thr * m0["thr_norm"] - lam.dsp * m0["dsp"]
    assert scored == want - 0.25 * m0["lat"]
    assert plain == want


def test_sim_latency_evaluator_batch_path_matches_serial():
    def run(s):
        tpu = s.pm.TPUModel(chips=2)
        base = s.hass.LMEvaluator(s.configs.get_config("qwen3-0.6b"), tpu,
                                  tpu.chip_budget, dse_iters=80)
        ev = s.sim.SimLatencyEvaluator(
            base, tpu, tpu.chip_budget,
            trace=s.sim.poisson_trace(60, 1e-6, sizes=16, seed=0),
            slo=s.sim.SLO(target=1e8), n_parts=2, batch=16, dse_iters=80)
        rng = np.random.default_rng(0)
        return ev, base, [rng.uniform(0.0, 0.8, ev.n_search)
                          for _ in range(3)]
    (jev, _, jxs), (ev, base, xs) = run(J), run(T)
    batched = ev.evaluate_batch(xs)
    assert _as_plain(batched) == _as_plain(jev.evaluate_batch(jxs))
    assert batched == [ev(x) for x in xs]
    assert all("lat" in m and "lat_cycles" in m for m in batched)


# --------------------------------------------------------------------- #
# test_faults.py twins: FaultTrace construction, validation, determinism
# --------------------------------------------------------------------- #
def test_fault_trace_validation_and_canonical_order():
    FT = tfaults.FaultTrace
    with pytest.raises(ValueError, match="columns"):
        FT(crashes=[[0.0, 1.0]])
    with pytest.raises(ValueError, match="t_end > t_start"):
        FT(crashes=[[0.0, 5.0, 5.0]])
    with pytest.raises(ValueError, match=">= 0"):
        FT(slowdowns=[[-1.0, 0.0, 1.0, 0.5]])
    with pytest.raises(ValueError, match="positive"):
        FT(ici=[[0.0, 0.0, 1.0, 0.0]])
    ft = both(lambda s: s.faults.FaultTrace(
        crashes=[[1, 50.0, 60.0], [0, 10.0, 20.0], [0, 5.0, 8.0]]))
    assert ft.crashes[:, 0].tolist() == [0, 0, 1]
    assert ft.crashes[:, 1].tolist() == [5.0, 10.0, 50.0]
    assert not ft.empty
    assert tsim.zero_fault_trace().empty and FT.none().empty
    rl = both(lambda s: s.sim.replica_loss(2, 100.0))
    assert rl.down_windows(2) == [(100.0, 1e30)]
    assert rl.down_windows(0) == []


def test_inject_faults_seeded_deterministic():
    kw = dict(crash_rate=2e-6, restart_mean=1e5, slow_rate=3e-6,
              slow_mean=5e4, slow_factor=0.4, n_hops=2, ici_rate=1e-6,
              ici_mean=1e5)
    a = both(lambda s: s.sim.inject_faults(3, 2e6, seed=7, **kw))
    b = tsim.inject_faults(3, 2e6, seed=7, **kw)
    c = both(lambda s: s.sim.inject_faults(3, 2e6, seed=8, **kw))
    assert _as_plain(a) == _as_plain(b)
    assert not (np.array_equal(a.crashes, c.crashes)
                and np.array_equal(a.slowdowns, c.slowdowns))
    assert not a.empty and a.kind == "injected"
    with pytest.raises(ValueError, match="n_units"):
        tsim.inject_faults(0, 1e6)
    with pytest.raises(ValueError, match="horizon"):
        tsim.inject_faults(1, 0.0)


def test_node_faults_delay_and_slowdown():
    def run(s):
        fx = s.faults.NodeFaults(
            down=[[(10.0, 25.0), (30.0, 40.0)]],
            slow=[[(40.0, 100.0, 0.5), (40.0, 100.0, 0.5)]])
        return fx(0, 12.0, 8.0), fx(0, 32.0, 8.0), fx(0, 0.0, 8.0)
    (occ, dn), (occ2, dn2), clean = both(run)
    assert dn == 13.0 and occ == 13.0 + 8.0
    assert dn2 == 8.0 and occ2 == 8.0 + 8.0 / 0.25
    assert clean == (8.0, 0.0)


# --------------------------------------------------------------------- #
# Engine bit-identity + conservation under faults
# --------------------------------------------------------------------- #
def _rand_chain(rng, n_nodes):
    n = int(rng.integers(40, 120))
    arr = np.sort(rng.uniform(0, 5e4, n))
    sizes = rng.integers(1, 16, n).astype(np.int64)
    rates = rng.uniform(5e-3, 5e-2, n_nodes)
    service = [(lambda r: (lambda s: s / r))(r) for r in rates]
    caps = [10**9] + [int(rng.integers(1, 4)) for _ in range(n_nodes - 1)]
    return arr, sizes, service, caps


def _faulted_chains(s, seed0=0, trials=6):
    rng = np.random.default_rng(seed0)
    out = []
    for trial in range(trials):
        m = int(rng.integers(1, 5))
        arr, sizes, service, caps = _rand_chain(rng, m)
        ft = s.sim.inject_faults(m, 6e4, crash_rate=3e-4, restart_mean=2e3,
                                 slow_rate=3e-4, slow_mean=3e3,
                                 slow_factor=0.5, seed=trial)
        fx = s.faults.NodeFaults(down=[ft.down_windows(u) for u in range(m)],
                                 slow=[ft.slow_windows(u) for u in range(m)])
        out.append([s.engine._simulate_chain(arr, sizes, service, caps, e, fx)
                    for e in ("heap", "calendar")])
    return out


def test_engines_bit_identical_and_conserve_under_faults():
    for heap, cal in both(_faulted_chains):
        assert _as_plain(heap) == _as_plain(cal)
        comp, busy, blk, idle, _, _, down = heap
        assert any(d > 0 for d in down), "fault set never fired"
        for k in range(len(busy)):
            total = busy[k] + blk[k] + idle[k] + down[k]
            assert total == pytest.approx(comp.max(), rel=1e-12)


def test_zero_fault_chain_matches_fx_none_bit_exact():
    def run(s):
        rng = np.random.default_rng(1)
        out = []
        for m in (1, 3):
            arr, sizes, service, caps = _rand_chain(rng, m)
            nul = s.faults.NodeFaults(down=[[] for _ in range(m)],
                                      slow=[[] for _ in range(m)])
            for eng in ("heap", "calendar"):
                out.append((
                    s.engine._simulate_chain(arr, sizes, service, caps, eng),
                    s.engine._simulate_chain(arr, sizes, service, caps, eng,
                                             nul)))
        return out
    for ref, got in both(run):
        assert _as_plain(ref) == _as_plain(got)


def test_simulate_partition_faults_perturb_and_account():
    def run(s):
        layers = cnn_stack(s, "resnet18", 0)
        tpu, p = tpu_partition(s, layers, 4, 16, "maxmin")
        rate = s.sim.request_rate(p.steady_throughput, 0.4, 16)
        tr = s.sim.mmpp_trace(200, 0.6 * rate, 3 * rate,
                              dwell_base=4 / rate, dwell_burst=1 / rate,
                              sizes=16, seed=0)
        clean = s.sim.simulate_partition(layers, tpu, p, tr)
        horizon = float(clean.completions.max())
        ft = s.sim.inject_faults(
            4, horizon, crash_rate=4.0 / horizon, restart_mean=horizon / 30,
            slow_rate=4.0 / horizon, slow_mean=horizon / 20,
            slow_factor=0.4, n_hops=3, ici_rate=2.0 / horizon,
            ici_mean=horizon / 20, seed=1)
        return (clean, s.sim.simulate_partition(layers, tpu, p, tr,
                                                faults=ft),
                s.sim.simulate_partition(layers, tpu, p, tr,
                                         faults=s.sim.zero_fault_trace()),
                s.sim.simulate_partition(layers, tpu, p, tr, faults=ft))
    clean, hurt, same, again = both(run)
    assert float(hurt.down.sum()) > 0
    assert hurt.p99 >= clean.p99
    assert _as_plain(same) == _as_plain(clean)
    assert _as_plain(again) == _as_plain(hurt)


def test_latency_percentile_zero_completions_raises():
    layers = cnn_stack(T, "resnet18", 0)
    tpu, p = tpu_partition(T, layers, 2, 16, "maxmin", dse_iters=60)
    rep = tsim.simulate_partition(layers, tpu, p, tsim.Trace(
        np.array([0.0]), np.array([16]), kind="replay"))
    rep.latency = rep.latency[:0]
    with pytest.raises(ValueError, match="zero completions"):
        tslo.latency_percentile(rep)


# --------------------------------------------------------------------- #
# Chaos fleet: validation, conservation, determinism
# --------------------------------------------------------------------- #
def test_fleet_validation_errors():
    AP, DP = tfleet.AutoscalePolicy, tfleet.DegradationPolicy
    tr = tsim.mmpp_trace(50, 1e-4, 5e-3, dwell_base=2e4, dwell_burst=1e4,
                         sizes=[8], seed=0)
    empty = tsim.Trace(np.array([]), np.array([]), kind="replay")
    with pytest.raises(ValueError, match="non-empty"):
        tfleet.simulate_fleet(empty, AP.static(1), **KW)
    with pytest.raises(ValueError, match="batch_slots"):
        tfleet.simulate_fleet(tr, AP.static(1), batch_slots=0,
                              step_cycles=10.0)
    with pytest.raises(ValueError, match="deadline_cycles"):
        tfleet.simulate_fleet(tr, AP.static(1), deadline_cycles=0.0, **KW)
    with pytest.raises(ValueError, match="batch_slots"):
        tfleet.open_loop_schedule([0.0], [8], batch_slots=0, step_cycles=1.0)
    for bad in (dict(min_replicas=0), dict(max_replicas=0),
                dict(min_replicas=3, max_replicas=2),
                dict(scale_up_backlog=0.0),
                dict(scale_up_backlog=1.0, scale_down_backlog=1.5),
                dict(scale_down_backlog=-0.1), dict(boundary_cycles=0.0),
                dict(admit_depth=0.0), dict(spinup_cycles=-1.0)):
        with pytest.raises(ValueError):
            AP(**bad)
    for bad in (dict(ladder=()), dict(ladder=(0.9,)),
                dict(ladder=(1.0, 0.5, 0.7)), dict(ladder=(1.0, 0.0)),
                dict(degrade_backlog=0.0),
                dict(recover_backlog=9.0, degrade_backlog=8.0),
                dict(dwell_cycles=-1.0), dict(switch_cycles=-1.0)):
        with pytest.raises(ValueError):
            DP(**bad)


def test_fleet_zero_fault_scenario_bit_identical():
    def run(s):
        tr = s.sim.mmpp_trace(300, 1e-4, 8e-3, dwell_base=1e5,
                              dwell_burst=4e4, sizes=[8, 16], seed=2)
        pol = s.fleet.AutoscalePolicy(min_replicas=1, max_replicas=3,
                                      scale_up_backlog=1.0,
                                      scale_down_backlog=0.2)
        return (s.fleet.simulate_fleet(tr, pol, **KW),
                s.fleet.simulate_fleet(tr, pol,
                                       faults=s.sim.zero_fault_trace(), **KW))
    ref, got = both(run)
    assert _as_plain(ref) == _as_plain(got)
    assert got.shed == 0 and got.retries.sum() == 0


def test_fleet_crash_retry_deterministic_and_conserving():
    def run(s):
        tr = s.sim.mmpp_trace(600, 2e-4, 1.5e-2, dwell_base=3e5,
                              dwell_burst=8e4, sizes=[8, 16], seed=0)
        peak = float(np.median(tr.arrivals))
        ft = s.sim.replica_loss(1, peak, peak + 5e5)
        two = s.fleet.AutoscalePolicy.static(2)
        return [s.fleet.simulate_fleet(tr, two, faults=ft, **KW)
                for _ in range(2)] + [s.fleet.simulate_fleet(tr, two, **KW)]
    a, b, clean = both(run)
    assert _as_plain(a) == _as_plain(b)
    assert a.retries.sum() > 0, "crash at peak never forced a re-dispatch"
    assert np.all(np.isfinite(a.completions[~a.shed_mask]))
    assert np.all(np.isinf(a.completions[a.shed_mask]))
    assert a.completed + a.shed == 600
    assert a.p99 > clean.p99


def test_fleet_retry_budget_sheds_not_loses():
    def run(s):
        tr = s.sim.Trace(np.arange(40) * 1e3, np.full(40, 8), kind="replay")
        return s.fleet.simulate_fleet(
            tr, s.fleet.AutoscalePolicy.static(1),
            faults=s.sim.replica_loss(0, 5e3),
            retry=s.fleet.RetryPolicy(max_retries=1, backoff_base=1e3), **KW)
    rep = both(run)
    assert rep.shed > 0 and rep.completed + rep.shed == 40
    assert np.all(np.isinf(rep.completions[rep.shed_mask]))
    assert np.all(rep.retries[rep.shed_mask] >= 1)


def test_fleet_deadline_sheds_and_filters_percentiles():
    def run(s):
        tr = s.sim.Trace(np.arange(60) * 10.0, np.full(60, 16),
                         kind="replay")
        return s.fleet.simulate_fleet(tr, s.fleet.AutoscalePolicy.static(1),
                                      deadline_cycles=2e3, **KW)
    rep = both(run)
    assert rep.shed > 0 and rep.completed > 0
    assert rep.p99 <= np.max(rep.latency[~rep.shed_mask])
    assert np.isfinite(rep.p99)


def test_degradation_sheds_strictly_fewer_at_equal_cost():
    kw = dict(batch_slots=8, step_cycles=100.0, prefill_cycles=300.0)

    def run(s):
        tr = s.sim.mmpp_trace(2000, 2e-4, 2e-2, dwell_base=2e5,
                              dwell_burst=1.5e5, sizes=[8, 16], seed=0)
        peak = float(np.median(tr.arrivals))
        ft = s.sim.replica_loss(1, peak, peak + 2e6)
        two = s.fleet.AutoscalePolicy.static(2)
        deg = s.fleet.DegradationPolicy(
            ladder=(1.0, 0.6, 0.35), degrade_backlog=3.0,
            recover_backlog=0.5, dwell_cycles=1e5, switch_cycles=1e4)
        return [s.fleet.simulate_fleet(tr, two, faults=ft,
                                       deadline_cycles=2e5,
                                       degradation=d, **kw)
                for d in (None, deg, deg)]
    plain, soft, again = both(run)
    assert soft.shed < plain.shed
    assert soft.replica_cycles <= plain.replica_cycles * (1 + 1e-9)
    rungs = [r for _, r in soft.rung_timeline]
    assert max(rungs) >= 1 and rungs[0] == 0
    assert _as_plain(again) == _as_plain(soft)


# --------------------------------------------------------------------- #
# Degradation ladder off the DSE frontier
# --------------------------------------------------------------------- #
def test_degradation_ladder_prices_valid_policy():
    def layers_of(s):
        rng = np.random.default_rng(0)
        return [s.pm.LayerCost(f"l{i}", macs=int(rng.integers(1e5, 1e6)),
                               m_dot=64, weight_count=1, act_in=1,
                               act_out=1, s_w=float(rng.uniform(0.2, 0.6)))
                for i in range(6)]
    rungs = both(lambda s: s.dse.degradation_ladder(
        layers_of(s), s.pm.FPGAModel(), budget=2000.0,
        s_extra=(0.0, 0.15, 0.3)))
    assert rungs[0].step_scale == 1.0 and rungs[0].s_extra == 0.0
    assert all(b.step_scale <= a.step_scale
               for a, b in zip(rungs, rungs[1:]))
    assert all(b.throughput >= a.throughput
               for a, b in zip(rungs, rungs[1:]))
    tfleet.DegradationPolicy(ladder=tuple(r.step_scale for r in rungs))
    for bad in ((0.1, 0.2), (0.0, 0.2, 0.2), (0.0, 1.0), ()):
        with pytest.raises(ValueError):
            tdse.degradation_ladder(layers_of(T), tpm.FPGAModel(), 2000.0,
                                    s_extra=bad)


# --------------------------------------------------------------------- #
# Failure-aware SLO / autoscale search
# --------------------------------------------------------------------- #
def test_slo_partition_search_failure_aware():
    def run(s):
        layers = cnn_stack(s, "resnet18", 0)
        tpu, mm = tpu_partition(s, layers, 4, 16, "maxmin")
        rate = s.sim.request_rate(mm.steady_throughput, 0.4, 16)
        tr = s.sim.mmpp_trace(200, 0.6 * rate, 3 * rate,
                              dwell_base=4 / rate, dwell_burst=1 / rate,
                              sizes=16, seed=0)
        rep0 = s.sim.simulate_partition(layers, tpu, mm, tr)
        slo = s.sim.SLO(target=rep0.p99 * 4.0)
        horizon = float(rep0.completions.max())
        ft = s.sim.inject_faults(4, horizon, slow_rate=6.0 / horizon,
                                 slow_mean=horizon / 10, slow_factor=0.3,
                                 seed=2)
        kw = dict(slo=slo, trace=tr, n_parts=4, batch=16, dse_iters=80)
        return [s.slo.slo_partition_search(layers, tpu, tpu.chip_budget,
                                           faults=f, **kw)
                for f in (ft, None, s.sim.zero_fault_trace())]
    r, blind, zero = both(run)
    assert r.objective == "slo"
    assert r.fault_reports is not None and len(r.fault_reports) == 1
    assert float(r.fault_reports[0].down.sum()) >= 0
    assert zero.cuts == blind.cuts and zero.fault_reports is None
    assert np.array_equal(zero.sim_report.completions,
                          blind.sim_report.completions)


def test_autoscale_policy_search_failure_aware_smoke():
    def run(s):
        tr = s.sim.mmpp_trace(400, 2e-4, 1.2e-2, dwell_base=2e5,
                              dwell_burst=8e4, sizes=[8, 16], seed=1)
        peak = float(np.median(tr.arrivals))
        ft = s.sim.replica_loss(0, peak, peak + 8e5)
        return [s.sim.autoscale_policy_search(
            tr, batch_slots=4, step_cycles=10.0, prefill_cycles=30.0,
            max_replicas=3, n_trials=8, seed=0, faults=ft,
            deadline_cycles=3e5) for _ in range(2)]
    (pol, rep, base), (pol2, rep2, _) = both(run)
    assert 1 <= pol.min_replicas <= pol.max_replicas == 3
    assert base["static_best"] in (1, 2, 3)
    assert rep.completed + rep.shed == 400
    assert pol2 == pol
    assert np.array_equal(rep2.completions, rep.completions)


def test_sim_package_exports_the_reference_names():
    assert sorted(tsim.__all__) == sorted(jsim.__all__)
    assert tsim.SIM_TOL == jsim.SIM_TOL
    for name in jsim.__all__:
        assert type(getattr(tsim, name)).__name__ == \
            type(getattr(jsim, name)).__name__, name


def test_deploy_flow_equals_the_reference_flow():
    """``deploy_run.deploy_compare`` against ``examples/deploy_sim.py``'s
    steps written out with the JAX package, at a short trace."""
    from repro.core.perf_model import lm_block_bounds, thin_cut_points
    from repro_torch.deploy_run import deploy_compare
    d = deploy_compare(iters=4, requests=200, dse_iters=120)
    cfg = jconfigs.get_config("qwen3_0_6b")
    tpu = jpm.TPUModel(chips=4)
    ev = jhass.LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=120)
    res = jhass.hass_search(ev, ev.n_search, iters=4, seed=0,
                            include_act=False, batch_size=4)
    layers = ev.sparse_layers(res.best_x)
    cuts = thin_cut_points(lm_block_bounds(layers), 10)
    cache = jdse.DSECache()
    kw = dict(n_parts=4, batch=32, dse_iters=120, cut_points=cuts,
              cache=cache)
    mm = jdse.partition_pipeline(layers, tpu, tpu.chip_budget,
                                 objective="maxmin", **kw)
    rate = jsim.request_rate(mm.steady_throughput, 0.45, 32)
    tr = jsim.mmpp_trace(200, 0.6 * rate, 3.0 * rate, dwell_base=4.0 / rate,
                         dwell_burst=1.0 / rate, sizes=32, seed=0)
    one = jdse.partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=1,
                                  batch=32, dse_iters=120, cut_points=cuts,
                                  cache=cache, objective="sum")
    slo = jsim.SLO(target=3.0 * 32 / one.part_throughput[0], quantile=99.0)
    sl = jdse.partition_pipeline(layers, tpu, tpu.chip_budget,
                                 objective="slo", slo=slo, trace=tr, **kw)
    assert _as_plain(d["maxmin"]) == _as_plain(mm)
    assert _as_plain(d["slo_pick"]) == _as_plain(sl)
    assert _as_plain(d["slo"]) == _as_plain(slo)
    assert d["slo_pick"].sim_report is not None
    assert _as_plain(d["reports"]["slo"]) == _as_plain(sl.sim_report)
