"""SLO-aware partition selection: simulation in the search loop (DESIGN.md §13).

Percentile latency under real traffic is not decomposable over pipeline
prefixes, so no exact DP can optimize it directly. Instead
``slo_partition_search`` closes the loop the cheap way the analytic
objectives already paid for: the per-P sum-form and max-min DP picks span
the rate/latency trade-off (max-min maximizes the steady rate and happily
takes more hops; sum minimizes total batch cycles and so avoids expensive
boundaries), every candidate is simulated against the *same* trace, and
the winner is the SLO-feasible candidate with the highest remaining
*capacity* — its analytic ``steady_throughput`` (ties: lowest simulated
tail latency, then fewer cuts). When the SLO does not bind this reduces to
the max-min pick; when it binds (the rate-optimal partition's simulated
tail violates the target) the search walks down the capacity order to the
fastest deployment that still meets it. When no candidate meets the SLO
the least-violating one is returned — degraded, not undefined. All candidates share one ``DSECache``, so the extra objective
sweeps re-read segment frontiers instead of re-searching them.

``SimLatencyEvaluator`` pushes the same term into the HASS loop itself: it
wraps an Eq. 6 evaluator, partitions + simulates each proposal's sparse
stack, and adds ``lat`` (tail latency / SLO target) to the metric dict —
scored by ``hass_search`` through ``Lambdas.lat``, so the TPE can trade
accuracy and throughput against serving latency.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.dse import DSECache, PartitionResult, partition_pipeline
from repro_torch.core.perf_model import HardwareModel, LayerCost, TPUModel
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.engine import SimReport, simulate_partition
from repro_torch.sim.faults import FaultTrace
from repro_torch.sim.trace import Trace


def _fault_set(faults) -> List[FaultTrace]:
    """Normalize a ``faults=`` argument — None, one ``FaultTrace``, or a
    sequence of them — to a list of non-empty scenarios."""
    if faults is None:
        return []
    if isinstance(faults, FaultTrace):
        faults = [faults]
    return [f for f in faults if not f.empty]


@dataclass(frozen=True)
class SLO:
    """A tail-latency service-level objective: the ``quantile`` (percentile
    in 0..100) of per-request latency must stay at or below ``target``
    cycles."""
    target: float
    quantile: float = 99.0

    @classmethod
    def p99_ms(cls, ms: float, hw: HardwareModel) -> "SLO":
        """p99 target given in milliseconds of the model's clock."""
        return cls(target=ms * 1e-3 * hw.freq, quantile=99.0)


def latency_percentile(report: SimReport, quantile: float = 99.0) -> float:
    """The ``latency_percentile`` objective term: tail latency (cycles) of
    one simulated deployment."""
    return report.latency_percentile(quantile)


def slo_partition_search(layers: Sequence[LayerCost], hw: HardwareModel,
                         budget: float, *, slo, trace: Trace,
                         n_parts: int, batch: int = 256,
                         reconfig_cycles: float = 5e7,
                         dse_iters: int = 300,
                         cut_points: Optional[Sequence[int]] = None,
                         cache: Optional[DSECache] = None,
                         chip_budgets: Optional[Sequence[float]] = None,
                         q_depth: int = 8,
                         mode: str = "auto",
                         faults=None,
                         recorder=None) -> PartitionResult:
    """``partition_pipeline(objective="slo")``: pick the partitioning whose
    *simulated* deployment meets the latency SLO (see module docstring for
    the candidate set and selection rule). ``slo`` is an ``SLO`` or a bare
    p99 target in cycles; ``trace`` is the offered load. The returned
    ``PartitionResult`` has ``objective="slo"`` and carries the winning
    candidate's ``sim_report``.

    ``faults`` (a ``FaultTrace`` or a sequence of them) makes the search
    *failure-aware*: every candidate is additionally simulated under each
    fault scenario and its feasibility latency becomes the WORST p99 over
    {nominal} ∪ scenarios — the winner is the max-capacity candidate whose
    tail survives the whole fault set, not just clear weather. The winner's
    per-scenario reports come back in ``fault_reports`` (nominal stays in
    ``sim_report``).

    ``recorder`` (a ``repro_torch.obs.FlightRecorder``) emits one JSONL record
    per simulated candidate — cuts, tail latency, capacity, feasibility,
    and simulate-phase wall time; when the process tracer is enabled each
    candidate also gets a span. Neither changes any returned value."""
    if trace is None:
        raise ValueError("objective='slo' needs trace= (the offered load)")
    if slo is None:
        raise ValueError("objective='slo' needs slo= (an SLO or a p99 "
                         "target in cycles)")
    if not isinstance(slo, SLO):
        slo = SLO(target=float(slo))
    multi_chip = isinstance(hw, TPUModel) and hw.chips > 1
    cache = DSECache() if cache is None else cache
    kw = dict(batch=batch, reconfig_cycles=reconfig_cycles,
              dse_iters=dse_iters, cut_points=cut_points, cache=cache,
              chip_budgets=chip_budgets)
    objectives = ("sum", "maxmin") if multi_chip else ("sum",)
    cands: List[PartitionResult] = []
    seen = set()
    for p in range(1, max(int(n_parts), 1) + 1):
        for obj in objectives:
            c = partition_pipeline(layers, hw, budget, n_parts=p,
                                   objective=obj, **kw)
            if tuple(c.cuts) not in seen:
                seen.add(tuple(c.cuts))
                cands.append(c)
    tr = get_tracer()
    obs = tr.enabled or recorder is not None
    clk = tr.now if tr.enabled else time.perf_counter
    if recorder is not None:
        recorder.header("slo_partition_search", n_parts=n_parts,
                        n_candidates=len(cands), slo_target=slo.target,
                        slo_quantile=slo.quantile, batch=batch,
                        dse_iters=dse_iters, mode=mode,
                        n_faults=len(_fault_set(faults)))
    scenarios = _fault_set(faults)
    sims: List[SimReport] = []
    fsims: List[List[SimReport]] = []
    durs: List[float] = []
    for k, c in enumerate(cands):
        t0 = clk() if obs else 0.0
        sims.append(simulate_partition(layers, hw, c, trace, q_depth=q_depth,
                                       reconfig_cycles=reconfig_cycles,
                                       mode=mode))
        fsims.append([simulate_partition(layers, hw, c, trace,
                                         q_depth=q_depth,
                                         reconfig_cycles=reconfig_cycles,
                                         mode=mode, faults=f)
                      for f in scenarios])
        t1 = clk() if obs else 0.0
        durs.append(t1 - t0)
        if tr.enabled:
            tr.add_span("slo.candidate", t0, t1, depth=0, i=k,
                        cuts=[int(v) for v in c.cuts])
    lats = [max([latency_percentile(r, slo.quantile)]
                + [latency_percentile(fr, slo.quantile) for fr in frs])
            for r, frs in zip(sims, fsims)]

    def capacity(c: PartitionResult) -> float:
        # the schedule's analytic saturation rate: spatial steady rate on a
        # multi-chip slice, amortized temporal rate otherwise
        return c.steady_throughput if sims[0].mode == "spatial" \
            else c.throughput

    feasible = [k for k in range(len(cands)) if lats[k] <= slo.target]
    if feasible:
        # capacity first (analytic — deterministic, unlike the drain-time
        # noise in a finite trace's achieved rate), then tail latency, then
        # fewer chips
        best = max(capacity(cands[k]) for k in feasible)
        tied = [k for k in feasible
                if capacity(cands[k]) >= best * (1 - 1e-12)]
        win = min(tied, key=lambda k: (lats[k], len(cands[k].cuts), k))
    else:
        win = min(range(len(cands)), key=lambda k: (lats[k], k))
    if recorder is not None:
        # scores only exist once the shared-trace sims are in, so the
        # per-candidate records land here rather than inside the sim loop
        for k, c in enumerate(cands):
            recorder.trial(index=k, x=[int(v) for v in c.cuts],
                           score=-lats[k],
                           metrics={"p99": lats[k],
                                    "capacity": capacity(c),
                                    "feasible": bool(lats[k] <= slo.target)},
                           phases={"simulate": durs[k]},
                           objective=c.objective)
        recorder.footer(winner=win, n_feasible=len(feasible))
    if tr.enabled:
        tr.count("slo.candidates", len(cands))
        tr.count("slo.feasible", len(feasible))
    out = replace(cands[win], objective="slo")
    out.sim_report = sims[win]
    if scenarios:
        out.fault_reports = fsims[win]
    return out


def autoscale_policy_search(trace: Trace, *, batch_slots: int,
                            step_cycles: float, prefill_cycles: float = 0.0,
                            buckets=None, max_replicas: int = 4,
                            slo=None, n_trials: int = 48, seed: int = 0,
                            faults=None, retry=None, degradation=None,
                            deadline_cycles=None, recorder=None):
    """TPE over fleet autoscaling-policy knobs (DESIGN.md §14).

    The search space is ``repro_torch.serve.fleet.AutoscalePolicy``'s knobs —
    replica floor (the count schedule's lower bound; the ceiling is
    ``max_replicas``), scale-up/scale-down backlog thresholds, admission
    threshold (``admit_depth``), and batch-boundary slack
    (``boundary_cycles``). Every candidate is scored by ``simulate_fleet``
    against the offered ``trace`` (typically a scaled diurnal or MMPP
    trace) and compared with the best *static* replica count, which is
    simulated first with the same machinery so modeling quirks cancel:

        score = -(replica_cycles / static_cost)
                - 100 * max(0, p99 / static_p99 - 1)       (maximized)

    i.e. spend as few replica-cycles as possible without giving up any
    tail latency versus the static fleet; an optional ``slo`` adds the
    same hinge against its absolute target. Returns ``(policy, report,
    baselines)`` where ``baselines`` maps each static replica count to its
    ``(p99, replica_cycles)`` and ``"static_best"`` to the winning count.
    The returned policy is the *feasible* trial (p99 no worse than the
    best static, and within the SLO when given) with the lowest cost;
    when no trial is feasible, the lowest-p99 trial — degraded, not
    undefined, mirroring ``slo_partition_search``.

    ``faults``/``retry``/``degradation``/``deadline_cycles`` pass through
    to every ``simulate_fleet`` call — static baselines and TPE trials
    alike, so the comparison stays apples-to-apples under the same fault
    scenario. With a deadline the scoring turns shed-aware: trials pay
    ``1000 * excess_shed_fraction`` versus the static best and feasibility
    additionally requires shedding no more than it, so the winner is the
    cheapest policy whose tail AND completion rate both survive the fault
    set (failure-aware SLO search, DESIGN.md §17).

    ``recorder`` (a ``repro_torch.obs.FlightRecorder``) logs one JSONL record
    per TPE trial — knob vector, score, p99/cost/shed, per-phase wall
    time — plus a footer carrying the baselines and the winner; when the
    process tracer is enabled each trial also gets propose/evaluate/tell
    spans. Neither changes any returned value."""
    from repro_torch.core.tpe import TPE
    from repro_torch.serve.fleet import AutoscalePolicy, simulate_fleet
    from repro_torch.serve.serve_loop import DEFAULT_BUCKETS

    buckets = DEFAULT_BUCKETS if buckets is None else buckets
    if slo is not None and not isinstance(slo, SLO):
        slo = SLO(target=float(slo))
    kw = dict(batch_slots=batch_slots, step_cycles=step_cycles,
              prefill_cycles=prefill_cycles, buckets=buckets,
              faults=faults, retry=retry, degradation=degradation,
              deadline_cycles=deadline_cycles)
    max_replicas = max(int(max_replicas), 1)
    n_req = len(trace.arrivals)
    tr = get_tracer()
    obs = tr.enabled or recorder is not None
    clk = tr.now if tr.enabled else time.perf_counter
    if recorder is not None:
        recorder.header("autoscale_policy_search", n_trials=n_trials,
                        seed=seed, max_replicas=max_replicas,
                        batch_slots=batch_slots, n_requests=n_req,
                        slo_target=(slo.target if slo is not None else None))

    def p99_of(rep) -> float:
        # a chaos trial that sheds every request has no latency sample;
        # treat it as infinitely slow rather than erroring the search
        return rep.p99 if rep.completed else float("inf")

    baselines = {}
    sheds = {}
    for r in range(1, max_replicas + 1):
        rep = simulate_fleet(trace, AutoscalePolicy.static(r), **kw)
        baselines[r] = (p99_of(rep), rep.replica_cycles)
        sheds[r] = rep.shed
    static_best = min(baselines, key=lambda r: (sheds[r], baselines[r][0],
                                                baselines[r][1], r))
    p99_s, cost_s = baselines[static_best]
    shed_s = sheds[static_best]
    baselines["static_best"] = static_best

    quantum_cycles = max(float(np.sort(np.asarray(list(buckets)))[0])
                         * step_cycles, 1.0)
    # knobs in log space where the scale is multiplicative
    lo = np.array([np.log(0.02), np.log(0.05), np.log(0.25 * quantum_cycles),
                   np.log(1.0), 1.0])
    hi = np.array([np.log(16.0), np.log(0.95), np.log(64.0 * quantum_cycles),
                   np.log(512.0), float(max_replicas) + 0.999])

    def decode(x) -> AutoscalePolicy:
        up = float(np.exp(x[0]))
        return AutoscalePolicy(
            min_replicas=int(np.clip(int(x[4]), 1, max_replicas)),
            max_replicas=max_replicas,
            scale_up_backlog=up,
            scale_down_backlog=float(np.exp(x[1])) * up,
            boundary_cycles=float(np.exp(x[2])),
            admit_depth=float(np.exp(x[3])))

    opt = TPE(lo, hi, seed=seed)
    trials = []
    for i in range(max(int(n_trials), 1)):
        t0 = clk() if obs else 0.0
        x = opt.ask()
        t1 = clk() if obs else 0.0
        pol = decode(x)
        rep = simulate_fleet(trace, pol, **kw)
        t2 = clk() if obs else 0.0
        p99_t = p99_of(rep)
        hinge = max(0.0, p99_t / p99_s - 1.0)
        if slo is not None:
            hinge += max(0.0, p99_t / slo.target - 1.0)
        shed_pen = 10.0 * max(0, rep.shed - shed_s) / max(n_req, 1)
        score = -(rep.replica_cycles / cost_s) - 100.0 * hinge \
            - 100.0 * shed_pen
        opt.tell(x, score)
        trials.append((pol, rep))
        t3 = clk() if obs else 0.0
        if tr.enabled:
            tr.add_span("trial", t0, t3, depth=0, i=i)
            tr.add_span("propose", t0, t1, depth=1)
            tr.add_span("evaluate", t1, t2, depth=1)
            tr.add_span("tell", t2, t3, depth=1)
        if recorder is not None:
            recorder.trial(index=i, x=x, score=score,
                           metrics={"p99": p99_t,
                                    "replica_cycles": rep.replica_cycles,
                                    "shed": rep.shed},
                           phases={"propose": t1 - t0, "evaluate": t2 - t1,
                                   "tell": t3 - t2})
    feasible = [k for k, (_, rep) in enumerate(trials)
                if p99_of(rep) <= p99_s and rep.shed <= shed_s
                and (slo is None or p99_of(rep) <= slo.target)]
    if feasible:
        win = min(feasible, key=lambda k: (trials[k][1].replica_cycles, k))
    else:
        win = min(range(len(trials)),
                  key=lambda k: (p99_of(trials[k][1]), k))
    policy, report = trials[win]
    if tr.enabled:
        tr.count("autoscale.trials", len(trials))
        tr.count("autoscale.feasible", len(feasible))
    if recorder is not None:
        recorder.footer(winner=win, n_feasible=len(feasible),
                        static_best=static_best,
                        static_p99=p99_s, static_cost=cost_s)
    return policy, report, baselines


class SimLatencyEvaluator:
    """Wrap an Eq. 6 evaluator (``LMEvaluator``/``CNNEvaluator``) with a
    simulated serving-latency term. Each proposal's sparse stack is
    partitioned (one shared ``DSECache`` across all proposals) and
    simulated against a fixed trace; the metric dict gains

      * ``lat``        — tail latency / SLO target (dimensionless; > 1
        means the proposal violates the SLO), subtracted by ``hass_search``
        as ``lambdas.lat * lat``;
      * ``lat_cycles`` — the raw simulated percentile, for reports.

    Everything else (``n_search``, ``sparse_layers``) passes through to
    the wrapped evaluator."""

    def __init__(self, base, hw: HardwareModel, budget: float, *, trace:
                 Trace, slo, n_parts: int, batch: int = 64,
                 dse_iters: int = 200,
                 cut_points: Optional[Sequence[int]] = None,
                 objective: str = "auto", q_depth: int = 8,
                 reconfig_cycles: float = 5e7):
        self.base = base
        self.hw, self.budget = hw, budget
        self.trace = trace
        self.slo = slo if isinstance(slo, SLO) else SLO(target=float(slo))
        self.n_parts, self.batch = n_parts, batch
        self.dse_iters, self.cut_points = dse_iters, cut_points
        self.objective, self.q_depth = objective, q_depth
        self.reconfig_cycles = reconfig_cycles
        self.cache = DSECache(materialize_designs=True)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def _lat_terms(self, x) -> dict:
        layers = self.base.sparse_layers(x)
        p = partition_pipeline(layers, self.hw, self.budget,
                               n_parts=self.n_parts, batch=self.batch,
                               reconfig_cycles=self.reconfig_cycles,
                               dse_iters=self.dse_iters,
                               cut_points=self.cut_points,
                               objective=self.objective, cache=self.cache)
        rep = simulate_partition(layers, self.hw, p, self.trace,
                                 q_depth=self.q_depth,
                                 reconfig_cycles=self.reconfig_cycles)
        lat = latency_percentile(rep, self.slo.quantile)
        return {"lat": lat / self.slo.target, "lat_cycles": lat}

    def __call__(self, x) -> dict:
        return {**dict(self.base(x)), **self._lat_terms(x)}

    def evaluate_batch(self, xs) -> List[dict]:
        """Keeps the wrapped evaluator's vectorized batch path (one vmapped
        prune+forward per round on the CNN evaluator) and adds the
        simulated-latency terms per proposal."""
        eval_batch = getattr(self.base, "evaluate_batch", None)
        ms = eval_batch(xs) if eval_batch is not None and len(xs) > 1 \
            else [self.base(x) for x in xs]
        return [{**dict(m), **self._lat_terms(x)} for x, m in zip(xs, ms)]
