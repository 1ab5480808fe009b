"""Fleet-scale open-loop serving: N replicas under an autoscaling policy.

The layer above ``ServeSession`` (DESIGN.md §14): a ``Trace``-shaped
request stream is split across up to ``max_replicas`` deployment replicas
by a deterministic online controller, and each replica's timing is scored
with ``open_loop_schedule`` — the *pure-timing twin* of
``ServeSession.serve_open_loop`` (same admission rounds, same bucket
boundaries, same virtual clock; the equality is pinned by a test, so a
simulated fleet schedule replays through the real serve path unchanged).

The controller is intentionally simple and fully seeded-deterministic:

  * **routing** — each arrival goes to the active replica with the least
    estimated outstanding work (JSQ on a work estimate that never peeks
    at exact completion times, so routing stays online/causal);
  * **admission threshold** — arrivals are *held* in a central queue
    while every active replica's estimated depth exceeds
    ``admit_depth``; held requests release at decision boundaries;
  * **autoscaling** — at every ``boundary_cycles`` decision boundary
    (the policy's batch-boundary slack) the controller compares the mean
    estimated backlog per active replica against the scale-up /
    scale-down thresholds and activates (after ``spinup_cycles``) or
    drains replicas between ``min_replicas`` and ``max_replicas``.

``replica_cycles`` integrates active-replica time — the cost axis the
autoscale policy search trades against tail latency
(``repro_torch.sim.slo.autoscale_policy_search``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import get_tracer
from repro_torch.serve.serve_loop import DEFAULT_BUCKETS, _norm_step_schedule
from repro_torch.sim.faults import NEVER, FaultTrace
from repro_torch.sim.trace import Trace, bucket_sizes


def _publish_fleet_obs(n: int, timeline, shed_mask=None, retries=None,
                       rung_tl=None) -> None:
    """End-of-run counter publication (DESIGN.md §18): everything here is
    derived from state the simulation already built, so the fleet loops
    carry zero per-event instrumentation cost in either tracer state."""
    tr = get_tracer()
    if not tr.enabled:
        return
    tr.count("fleet.runs")
    tr.count("fleet.requests", n)
    tr.count("fleet.scale_events", max(len(timeline) - 1, 0))
    if shed_mask is not None:
        tr.count("fleet.shed", int(shed_mask.sum()))
    if retries is not None:
        tr.count("fleet.retries", int(retries.sum()))
    if rung_tl is not None:
        tr.count("fleet.rung_transitions", max(len(rung_tl) - 1, 0))


def open_loop_schedule(arrivals: Sequence[float], max_new: Sequence[int], *,
                       batch_slots: int, step_cycles: float,
                       prefill_cycles: float = 0.0,
                       buckets: Sequence[int] = DEFAULT_BUCKETS,
                       deadlines: Optional[Sequence[float]] = None,
                       step_schedule: Optional[Sequence] = None,
                       switch_cycles: float = 0.0):
    """Pure-timing twin of ``ServeSession.serve_open_loop``: the same
    admission rounds, bucket quanta, and virtual clock, with the model
    calls stripped out (one prefill per admission round — the uniform
    prompt-length case). Returns ``(admissions, completions)`` arrays in
    input order. Keep in lockstep with ``serve_open_loop``; the test
    suite asserts the two produce identical ``ServeReport`` timings.

    ``deadlines`` (absolute cycles) sheds a request whose admission round
    opens past its deadline: its completion is ``inf`` and its admission
    records the shed time. ``step_schedule``/``switch_cycles`` are the
    degradation hook — sorted ``(t, scale)`` rung breakpoints scaling the
    decode-step cost, a partition-switch stall charged per breakpoint
    crossed while actively serving (idle crossings re-point silently) —
    mirroring ``serve_open_loop`` exactly (DESIGN.md §17)."""
    n = len(arrivals)
    arr = np.asarray(arrivals, dtype=np.float64)
    if batch_slots < 1:
        raise ValueError("batch_slots must be >= 1")
    b = np.sort(np.asarray(list(buckets), dtype=np.int64))
    if len(b) == 0 or b[0] < 1 or np.any(b % b[0] != 0):
        raise ValueError("buckets must be multiples of the smallest "
                         "(the admission quantum)")
    quantum = int(b[0])
    mn = np.asarray(max_new, dtype=np.int64)
    dl = (np.full(n, np.inf) if deadlines is None
          else np.asarray(deadlines, dtype=np.float64))
    quota = np.zeros(n, dtype=np.int64)
    alive = mn > 0
    if alive.any():
        quota[alive] = bucket_sizes(mn[alive], b)
    order = sorted(range(n), key=lambda i: arr[i])
    admissions = np.zeros(n, dtype=np.float64)
    completions = np.zeros(n, dtype=np.float64)
    done = np.zeros(n, dtype=bool)
    waiting = deque(order)
    groups: List[dict] = []
    free = batch_slots
    t = 0.0
    sc_t, sc_v = _norm_step_schedule(step_schedule)
    si = 0
    eff_step = step_cycles
    while waiting or groups:
        if not groups and waiting:
            t = max(t, arr[waiting[0]])
            while si < len(sc_t) and sc_t[si] <= t:       # silent re-point
                eff_step = step_cycles * sc_v[si]
                si += 1
        admit: List[int] = []
        while waiting and free > 0 and arr[waiting[0]] <= t:
            i = waiting.popleft()
            if t > dl[i]:
                admissions[i] = t
                completions[i] = np.inf
                done[i] = True
                continue
            admit.append(i)
            free -= 1
        if admit:
            while si < len(sc_t) and sc_t[si] <= t:          # rung switch
                eff_step = step_cycles * sc_v[si]
                si += 1
                t += switch_cycles
            t += prefill_cycles
            for i in admit:
                admissions[i] = t
                if quota[i] == 0:
                    completions[i] = t
                    done[i] = True
                    free += 1
            if any(quota[i] > 0 for i in admit):
                groups.append({"rows": admit, "taken": 1})
        for g in groups:
            while si < len(sc_t) and sc_t[si] <= t:          # rung switch
                eff_step = step_cycles * sc_v[si]
                si += 1
                t += switch_cycles
            cap = int(max(quota[i] for i in g["rows"])) - g["taken"]
            steps = quantum - (g["taken"] % quantum or quantum)
            steps = min(steps or quantum, cap)
            g["taken"] += steps
            t += steps * eff_step
            for i in g["rows"]:
                if not done[i] and 0 < quota[i] <= g["taken"]:
                    completions[i] = t
                    done[i] = True
                    free += 1
        groups = [g for g in groups
                  if g["taken"] < max(quota[i] for i in g["rows"])]
    return admissions, completions


@dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs of the fleet controller (the autoscale search space).
    Backlog thresholds are estimated queued requests per active replica;
    ``boundary_cycles`` spaces the decision boundaries (batch-boundary
    slack); ``admit_depth`` is the admission threshold — the estimated
    per-replica depth beyond which arrivals wait in the central queue."""
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_backlog: float = 4.0
    scale_down_backlog: float = 0.5
    boundary_cycles: float = 1e5
    admit_depth: float = 1e9
    spinup_cycles: float = 0.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.scale_up_backlog <= 0:
            raise ValueError("scale_up_backlog must be positive")
        if not (0 <= self.scale_down_backlog < self.scale_up_backlog):
            raise ValueError("scale_down_backlog must be in "
                             "[0, scale_up_backlog)")
        if self.boundary_cycles <= 0:
            raise ValueError("boundary_cycles must be positive")
        if self.admit_depth <= 0:
            raise ValueError("admit_depth must be positive")
        if self.spinup_cycles < 0:
            raise ValueError("spinup_cycles must be >= 0")

    @classmethod
    def static(cls, replicas: int, boundary_cycles: float = 1e5
               ) -> "AutoscalePolicy":
        """A fixed replica count — the baseline the searched policy must
        beat (lower p99, or equal p99 at lower replica-cycles)."""
        return cls(min_replicas=replicas, max_replicas=replicas,
                   boundary_cycles=boundary_cycles)


@dataclass(frozen=True)
class RetryPolicy:
    """Failure-recovery knobs of the JSQ dispatcher (DESIGN.md §17).
    A request whose replica crashes mid-flight re-enqueues to the central
    hold queue and re-dispatches after a capped exponential backoff
    (``base * factor**(attempt-1)``, at most ``cap`` cycles); a request
    whose best candidate's estimated start lies more than
    ``timeout_cycles`` in the future is not parked on a hopeless replica
    but backs off the same way. ``max_retries`` re-dispatches later the
    request is *shed* — dropped and accounted, never silently lost."""
    max_retries: int = 2
    backoff_base: float = 1e4
    backoff_factor: float = 2.0
    backoff_cap: float = 1e6
    timeout_cycles: float = float("inf")

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base <= 0:
            raise ValueError("backoff_base must be positive")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if self.backoff_cap < self.backoff_base:
            raise ValueError("backoff_cap must be >= backoff_base")
        if self.timeout_cycles <= 0:
            raise ValueError("timeout_cycles must be positive")

    def backoff(self, attempt: int) -> float:
        """Re-dispatch delay before the ``attempt``-th retry (1-based)."""
        return min(self.backoff_base
                   * self.backoff_factor ** (attempt - 1),
                   self.backoff_cap)


@dataclass(frozen=True)
class DegradationPolicy:
    """Graceful degradation down the sparsity Pareto frontier (DESIGN.md
    §17). ``ladder`` holds relative decode-step costs per rung —
    ``ladder[0] == 1.0`` is the deployed operating point, deeper rungs
    are sparser/cheaper frontier designs (``core.dse.degradation_ladder``
    derives them from a stored ``ParetoFrontier``). On sustained queue
    growth or replica loss the controller steps one rung down (cheaper),
    on recovery one rung back up, each move separated by
    ``dwell_cycles`` and priced at ``switch_cycles`` — the temporal
    partition-switch stall each replica pays when it crosses the rung
    boundary while serving."""
    ladder: Tuple[float, ...] = (1.0,)
    degrade_backlog: float = 8.0
    recover_backlog: float = 1.0
    dwell_cycles: float = 1e5
    switch_cycles: float = 0.0

    def __post_init__(self):
        lad = tuple(float(v) for v in self.ladder)
        object.__setattr__(self, "ladder", lad)
        if not lad or lad[0] != 1.0:
            raise ValueError("ladder[0] must be 1.0 (the deployed "
                             "operating point)")
        if any(v <= 0 for v in lad):
            raise ValueError("ladder entries must be positive step-cycle "
                             "multipliers")
        if any(b > a for a, b in zip(lad, lad[1:])):
            raise ValueError("ladder must be nonincreasing (deeper rungs "
                             "are cheaper)")
        if not (0 <= self.recover_backlog < self.degrade_backlog):
            raise ValueError("need 0 <= recover_backlog < degrade_backlog")
        if self.dwell_cycles < 0 or self.switch_cycles < 0:
            raise ValueError("dwell_cycles/switch_cycles must be >= 0")


@dataclass
class FleetReport:
    """What the fleet did with one trace. Per-request arrays are in trace
    order; ``latency`` runs from the original arrival (central-queue hold
    + spinup + per-replica queueing all included), so the percentiles
    compare directly against an ``SLO`` target and against a single
    replica's ``ServeReport``/``SimReport``."""
    arrivals: np.ndarray
    admissions: np.ndarray        # admission into the replica's batch
    completions: np.ndarray
    latency: np.ndarray
    assignment: np.ndarray        # (N,) replica index per request
    routed_at: np.ndarray         # (N,) when routing released the request
    replica_cycles: float         # integral of active replicas over time
    replicas_max: int
    timeline: List[Tuple[float, int]] = field(default_factory=list)
    shed_mask: np.ndarray = None  # (N,) True = dropped (deadline/retries)
    retries: np.ndarray = None    # (N,) re-dispatch attempts per request
    rung_timeline: List[Tuple[float, int]] = field(default_factory=list)

    def __post_init__(self):
        if self.shed_mask is None:
            self.shed_mask = np.zeros(len(self.arrivals), dtype=bool)
        if self.retries is None:
            self.retries = np.zeros(len(self.arrivals), dtype=np.int64)

    @property
    def completed(self) -> int:
        return int((~self.shed_mask).sum())

    @property
    def shed(self) -> int:
        return int(self.shed_mask.sum())

    @property
    def horizon(self) -> float:
        served = self.completions[~self.shed_mask]
        return float(served.max()) if len(served) else 0.0

    def latency_percentile(self, quantile: float) -> float:
        lat = self.latency[~self.shed_mask]
        if len(lat) == 0:
            raise ValueError(
                "latency_percentile on a report with zero completions")
        return float(np.percentile(lat, quantile))

    @property
    def p50(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99(self) -> float:
        return self.latency_percentile(99.0)


def simulate_fleet(trace: Trace, policy: AutoscalePolicy, *,
                   batch_slots: int, step_cycles: float,
                   prefill_cycles: float = 0.0,
                   buckets: Sequence[int] = DEFAULT_BUCKETS,
                   faults: Optional[FaultTrace] = None,
                   retry: Optional[RetryPolicy] = None,
                   degradation: Optional[DegradationPolicy] = None,
                   deadline_cycles: Optional[float] = None) -> FleetReport:
    """Run ``trace`` through the fleet controller and score every replica
    with the exact open-loop timing model. Trace sizes are the decode
    lengths (``max_new``), as in ``requests_from_trace``.

    The chaos extensions (DESIGN.md §17) are all opt-in and leave the
    fault-free path untouched (bit-identity gated in ``chaos_bench``):

      * ``faults`` — a ``FaultTrace`` whose crash rows are replica
        crash/restart windows (unit = replica index). In-flight requests
        on a crashed replica re-enqueue to the central hold queue and
        re-dispatch under ``retry``'s capped exponential backoff;
        retries-exhausted requests are shed, never silently lost.
      * ``retry`` — ``RetryPolicy`` (defaults apply whenever ``faults``
        is given): retry budget, backoff, and the dispatch timeout.
      * ``degradation`` — ``DegradationPolicy``: on sustained backlog or
        replica loss the fleet steps down its sparsity-frontier ladder
        (cheaper decode steps, a switch stall per rung move), stepping
        back up on recovery; the rung schedule prices every replica's
        exact timing via ``open_loop_schedule(step_schedule=...)``.
      * ``deadline_cycles`` — per-request relative deadline: a request
        not admitted within this many cycles of its arrival is shed.
    """
    n = len(trace)
    if n == 0:
        raise ValueError("simulate_fleet needs a non-empty trace")
    if batch_slots < 1:
        raise ValueError("batch_slots must be >= 1")
    if deadline_cycles is not None and deadline_cycles <= 0:
        raise ValueError("deadline_cycles must be positive")
    chaos = ((faults is not None and not faults.empty)
             or retry is not None or degradation is not None
             or deadline_cycles is not None)
    if chaos:
        return _simulate_fleet_chaos(
            trace, policy, batch_slots=batch_slots, step_cycles=step_cycles,
            prefill_cycles=prefill_cycles, buckets=buckets,
            faults=faults if faults is not None else FaultTrace.none(),
            retry=retry if retry is not None else RetryPolicy(),
            degradation=degradation, deadline_cycles=deadline_cycles)
    arr = np.asarray(trace.arrivals, dtype=np.float64)
    mn = np.asarray(trace.sizes, dtype=np.int64)
    b = np.sort(np.asarray(list(buckets), dtype=np.int64))
    quota = bucket_sizes(np.maximum(mn, 1), b)
    # online work estimate per request: one batch-amortized service time
    w = (prefill_cycles + quota * step_cycles) / max(batch_slots, 1)
    w_avg = float(w.mean()) if n else 1.0
    R = policy.max_replicas
    ready = np.zeros(R)            # estimated drain time per replica
    start = np.full(R, np.nan)     # current stint's activation time
    segs: List[List[Tuple[float, float]]] = [[] for _ in range(R)]
    avail = np.zeros(R)            # activation + spinup
    active = int(np.clip(policy.min_replicas, 1, R))
    for r in range(active):
        start[r] = 0.0
    assignment = np.full(n, -1, dtype=np.int64)
    routed_at = np.zeros(n)
    held: deque = deque()
    timeline: List[Tuple[float, int]] = [(0.0, active)]
    boundary = float(max(policy.boundary_cycles, 1.0))
    next_b = boundary

    def depth(r: int, t: float) -> float:
        return max(ready[r] - t, 0.0) / w_avg

    def route(i: int, t: float) -> None:
        cands = [r for r in range(active)]
        r = min(cands, key=lambda r: (max(ready[r], t, avail[r]), r))
        eff = max(arr[i], t, avail[r])
        ready[r] = max(ready[r], eff) + w[i]
        assignment[i] = r
        routed_at[i] = eff

    def scale_up(t: float) -> None:
        # reactive: runs at every arrival as well as at boundaries, so a
        # burst onset adds capacity before queueing builds (scale-down
        # stays boundary-gated — that is the hysteresis knob)
        nonlocal active
        per = (sum(depth(r, t) for r in range(active)) + len(held)) / active
        while per > policy.scale_up_backlog and active < R:
            start[active] = t
            avail[active] = t + policy.spinup_cycles
            active += 1
            timeline.append((t, active))
            per = (sum(depth(r, t) for r in range(active)) + len(held)) \
                / active

    def decide(t: float) -> None:
        nonlocal active
        scale_up(t)
        per = (sum(depth(r, t) for r in range(active)) + len(held)) / active
        while (per < policy.scale_down_backlog
               and active > max(policy.min_replicas, 1)
               and ready[active - 1] <= t):
            segs[active - 1].append((start[active - 1], t))
            start[active - 1] = np.nan
            active -= 1
            timeline.append((t, active))
            per = (sum(depth(r, t) for r in range(active)) + len(held)) \
                / active if active else 0.0
        while held and min(depth(r, t) for r in range(active)) \
                < policy.admit_depth:
            route(held.popleft(), t)

    for i in range(n):
        t = arr[i]
        while next_b <= t:
            decide(next_b)
            next_b += boundary
        scale_up(t)
        if held or min(depth(r, t) for r in range(active)) \
                >= policy.admit_depth:
            held.append(i)              # admission threshold: hold centrally
        else:
            route(i, t)
    t = arr[-1] if n else 0.0
    while held:
        next_b = max(next_b, t + boundary)
        decide(next_b)
        t = next_b
        next_b += boundary

    # exact per-replica open-loop timing on the final assignment
    admissions = np.zeros(n)
    completions = np.zeros(n)
    for r in range(R):
        idx = np.flatnonzero(assignment == r)
        if len(idx) == 0:
            continue
        adm, comp = open_loop_schedule(
            routed_at[idx], mn[idx], batch_slots=batch_slots,
            step_cycles=step_cycles, prefill_cycles=prefill_cycles,
            buckets=buckets)
        admissions[idx] = adm
        completions[idx] = comp
    horizon = float(completions.max()) if n else 0.0
    cost = 0.0
    for r in range(R):
        if not np.isnan(start[r]):       # still active: runs to the horizon
            segs[r].append((start[r], horizon))
        if not segs[r]:
            continue
        idx = np.flatnonzero(assignment == r)
        if len(idx):                     # drain past a scheduled stop: the
            s0, s1 = segs[r][-1]         # estimate said drained, exact
            segs[r][-1] = (s0, max(s1, float(completions[idx].max())))
        cost += sum(max(s1 - s0, 0.0) for s0, s1 in segs[r])
    _publish_fleet_obs(n, timeline)
    return FleetReport(arrivals=arr, admissions=admissions,
                       completions=completions, latency=completions - arr,
                       assignment=assignment, routed_at=routed_at,
                       replica_cycles=cost,
                       replicas_max=int(max(c for _, c in timeline)),
                       timeline=timeline)


def _simulate_fleet_chaos(trace: Trace, policy: AutoscalePolicy, *,
                          batch_slots: int, step_cycles: float,
                          prefill_cycles: float, buckets: Sequence[int],
                          faults: FaultTrace, retry: RetryPolicy,
                          degradation: Optional[DegradationPolicy],
                          deadline_cycles: Optional[float]) -> FleetReport:
    """Fault-injected fleet controller (DESIGN.md §17). Same deterministic
    JSQ/threshold/autoscale machinery as the pristine path, run as one
    merged event stream (arrivals, decision boundaries, replica crashes
    and restarts, retry releases). A replica's serving history splits
    into *epochs* at its crashes: the exact open-loop schedule of the
    epoch's routed requests decides, at crash time, which completed
    before the crash (their clocks are final — later events cannot reach
    back) and which are crash victims that re-enqueue with backoff.
    Conservation is asserted on exit: every request either completes
    (finite clock) or is shed with its retry count accounted."""
    import heapq

    n = len(trace)
    arr = np.asarray(trace.arrivals, dtype=np.float64)
    mn = np.asarray(trace.sizes, dtype=np.int64)
    b = np.sort(np.asarray(list(buckets), dtype=np.int64))
    quota = bucket_sizes(np.maximum(mn, 1), b)
    w = (prefill_cycles + quota * step_cycles) / max(batch_slots, 1)
    w_avg = float(w.mean()) if n else 1.0
    dl = (np.full(n, np.inf) if deadline_cycles is None
          else arr + float(deadline_cycles))
    R = policy.max_replicas
    ready = np.zeros(R)
    start = np.full(R, np.nan)
    up = [True] * R
    segs: List[List[Tuple[float, float]]] = [[] for _ in range(R)]
    avail = np.zeros(R)
    active = int(np.clip(policy.min_replicas, 1, R))
    for r in range(active):
        start[r] = 0.0
    assignment = np.full(n, -1, dtype=np.int64)
    routed_at = np.zeros(n)
    admissions = np.zeros(n)
    completions = np.zeros(n)
    final = np.zeros(n, dtype=bool)       # clock recorded, never revisited
    shed_mask = np.zeros(n, dtype=bool)
    retries = np.zeros(n, dtype=np.int64)
    ep_idx: List[List[int]] = [[] for _ in range(R)]   # current epoch
    ep_rt: List[List[float]] = [[] for _ in range(R)]
    held: deque = deque()
    timeline: List[Tuple[float, int]] = [(0.0, active)]
    boundary = float(max(policy.boundary_cycles, 1.0))
    next_b = boundary

    ladder = degradation.ladder if degradation is not None else (1.0,)
    rung = 0
    rung_tl: List[Tuple[float, int]] = [(0.0, 0)]
    bps: List[Tuple[float, float]] = []   # (t, scale) rung breakpoints
    last_move = 0.0
    sw_cycles = degradation.switch_cycles if degradation is not None else 0.0

    def sched_kw(at_bps):
        return dict(batch_slots=batch_slots, step_cycles=step_cycles,
                    prefill_cycles=prefill_cycles, buckets=buckets,
                    step_schedule=list(at_bps) or None,
                    switch_cycles=sw_cycles)

    def shed(i: int, t: float) -> None:
        shed_mask[i] = True
        admissions[i] = t
        completions[i] = np.inf
        final[i] = True

    def depth(r: int, t: float) -> float:
        return max(ready[r] - t, 0.0) / w_avg

    def cands(t: float) -> List[int]:
        return [r for r in range(active) if up[r]]

    def route(i: int, t: float) -> bool:
        """Dispatch (or re-dispatch) request i. Returns False when the
        dispatch timed out and was pushed to the retry stream instead."""
        cs = cands(t)
        r = min(cs, key=lambda r: (max(ready[r], t, avail[r]), r))
        eff = max(arr[i], t, avail[r])
        if max(ready[r], eff) - max(arr[i], t) > retry.timeout_cycles:
            retries[i] += 1
            if retries[i] > retry.max_retries:
                shed(i, t)
            else:
                heapq.heappush(evq, (t + retry.backoff(int(retries[i])),
                                     2, i, i))
            return False
        ready[r] = max(ready[r], eff) + w[i]
        assignment[i] = r
        routed_at[i] = eff
        ep_idx[r].append(i)
        ep_rt[r].append(eff)
        return True

    def scale_up(t: float) -> None:
        nonlocal active
        per = (sum(depth(r, t) for r in range(active)) + len(held)) / active
        while per > policy.scale_up_backlog and active < R:
            start[active] = t
            avail[active] = max(avail[active],
                                t + policy.spinup_cycles)
            active += 1
            timeline.append((t, active))
            per = (sum(depth(r, t) for r in range(active)) + len(held)) \
                / active

    def move_rung(t: float, to: int) -> None:
        nonlocal rung, last_move
        rung = to
        bps.append((t, ladder[rung]))
        rung_tl.append((t, rung))
        last_move = t

    def degrade_eval(t: float) -> None:
        if degradation is None:
            return
        cs = cands(t)
        per = (sum(depth(r, t) for r in cs) + len(held)) / max(len(cs), 1)
        if t - last_move < degradation.dwell_cycles:
            return
        if ((per > degradation.degrade_backlog or not cs)
                and rung < len(ladder) - 1):
            move_rung(t, rung + 1)
        elif cs and per < degradation.recover_backlog and rung > 0:
            # recovery needs a live candidate: with every replica down the
            # empty backlog is vacuous, not a recovery signal
            move_rung(t, rung - 1)

    def decide(t: float) -> None:
        nonlocal active
        scale_up(t)
        per = (sum(depth(r, t) for r in range(active)) + len(held)) / active
        while (per < policy.scale_down_backlog
               and active > max(policy.min_replicas, 1)
               and ready[active - 1] <= t):
            if not np.isnan(start[active - 1]):
                segs[active - 1].append((start[active - 1], t))
                start[active - 1] = np.nan
            active -= 1
            timeline.append((t, active))
            per = (sum(depth(r, t) for r in range(active)) + len(held)) \
                / active if active else 0.0
        degrade_eval(t)
        while held:
            cs = cands(t)
            if not cs or min(depth(r, t) for r in cs) >= policy.admit_depth:
                break
            route(held.popleft(), t)

    def close_epoch(r: int, t_down: float) -> List[int]:
        """Finalize replica r's epoch at a crash: record the clocks that
        are already in the past, return the crash victims."""
        idx, rts = ep_idx[r], ep_rt[r]
        ep_idx[r], ep_rt[r] = [], []
        if not idx:
            return []
        adm, comp = open_loop_schedule(rts, mn[idx],
                                       deadlines=dl[idx], **sched_kw(bps))
        victims: List[int] = []
        for j, i in enumerate(idx):
            if np.isinf(comp[j]) and adm[j] <= t_down:
                shed(i, adm[j])           # deadline-shed before the crash
            elif comp[j] <= t_down:
                admissions[i] = adm[j]    # completed before the crash
                completions[i] = comp[j]
                final[i] = True
            else:
                victims.append(i)         # in flight or queued at the crash
        return victims

    # merged deterministic event stream: (t, kind, seq, payload) with
    # kind 0=restart, 1=crash, 2=retry release, 3=arrival — restarts
    # resolve before crashes before retries before arrivals at equal t
    evq: List[tuple] = [(arr[i], 3, i, i) for i in range(n)]
    for r in range(R):
        for t0, t1 in faults.down_windows(r):
            evq.append((t0, 1, r, (r, t1)))
            if t1 < NEVER:            # terminal crashes never restart
                evq.append((t1, 0, r, r))
    heapq.heapify(evq)

    def boundaries_quiescent(tb: float) -> bool:
        """True when no boundary decision in [tb, next event) can change
        state: every trigger's argument (replica backlog) is nonincreasing
        between events, so a condition false at ``tb`` stays false — the
        catch-up loop may fast-forward instead of stepping ``boundary`` at
        a time across a long event gap (e.g. a far-future restart)."""
        if held:
            return False
        if active > max(policy.min_replicas, 1):
            return False               # a later boundary may scale down
        if active < R:
            per = sum(depth(r, tb) for r in range(active)) / active
            if per > policy.scale_up_backlog:
                return False
        if degradation is not None:
            cs = cands(tb)
            if not cs:
                return rung >= len(ladder) - 1
            per = sum(depth(r, tb) for r in cs) / len(cs)
            if per > degradation.degrade_backlog and rung < len(ladder) - 1:
                return False
            if rung > 0 and degradation.recover_backlog > 0.0:
                return False           # backlog drains toward recovery
        return True

    t = 0.0
    while evq:
        te, kind, _, x = heapq.heappop(evq)
        while next_b <= te:
            decide(next_b)
            next_b += boundary
            if next_b <= te and boundaries_quiescent(next_b):
                skip = int((te - next_b) // boundary) + 1
                next_b += skip * boundary
        t = te
        if kind == 0:                                  # restart
            r = x
            up[r] = True
            avail[r] = max(avail[r], te)
            ready[r] = max(ready[r], te)
            if r < active and np.isnan(start[r]):
                start[r] = te
            decide(te)
        elif kind == 1:                                # crash
            r, t_up = x
            if not up[r]:
                continue
            up[r] = False
            avail[r] = t_up
            ready[r] = t_up
            victims = close_epoch(r, te)
            if not np.isnan(start[r]):
                segs[r].append((start[r], te))
                start[r] = np.nan
            for i in victims:
                retries[i] += 1
                if retries[i] > retry.max_retries:
                    shed(i, te)
                else:
                    heapq.heappush(
                        evq, (te + retry.backoff(int(retries[i])), 2, i, i))
            if degradation is not None and rung < len(ladder) - 1 \
                    and te - last_move >= degradation.dwell_cycles:
                move_rung(te, rung + 1)                # replica loss
            scale_up(te)
        elif kind == 2:                                # retry release
            i = x
            if final[i]:
                continue
            scale_up(te)
            if held or not cands(te) or \
                    min(depth(r, te) for r in cands(te)) \
                    >= policy.admit_depth:
                held.append(i)
            else:
                route(i, te)
        else:                                          # arrival
            i = x
            scale_up(te)
            if held or not cands(te) or \
                    min(depth(r, te) for r in cands(te)) \
                    >= policy.admit_depth:
                held.append(i)
            else:
                route(i, te)

    # drain the central hold queue (all crash/restart events are past)
    while held:
        if not any(up[r] for r in range(R)):
            while held:                   # dead fleet, nothing will restart
                i = held.popleft()
                retries[i] += 1
                shed(i, t)
            break
        if not cands(t):
            spare = next(r for r in range(active, R) if up[r])
            start[spare] = t
            avail[spare] = max(avail[spare], t + policy.spinup_cycles)
            active = spare + 1
            timeline.append((t, active))
        next_b = max(next_b, t + boundary)
        decide(next_b)
        t = next_b
        next_b += boundary

    # exact timing of every replica's final epoch, full rung schedule
    for r in range(R):
        idx, rts = ep_idx[r], ep_rt[r]
        if not idx:
            continue
        adm, comp = open_loop_schedule(rts, mn[idx],
                                       deadlines=dl[idx], **sched_kw(bps))
        for j, i in enumerate(idx):
            if np.isinf(comp[j]):
                shed(i, adm[j])
            else:
                admissions[i] = adm[j]
                completions[i] = comp[j]
                final[i] = True
    assert final.all() \
        and np.isfinite(completions[~shed_mask]).all() \
        and np.isinf(completions[shed_mask]).all(), \
        "fleet conservation broken: a request is neither completed nor shed"

    served = completions[~shed_mask]
    horizon = float(served.max()) if len(served) else t
    cost = 0.0
    for r in range(R):
        if not np.isnan(start[r]):       # still active: runs to the horizon
            segs[r].append((start[r], horizon))
        if not segs[r]:
            continue
        if ep_idx[r]:                    # drain past a scheduled stop
            fin = [completions[i] for i in ep_idx[r] if not shed_mask[i]]
            if fin:
                s0, s1 = segs[r][-1]
                segs[r][-1] = (s0, max(s1, float(max(fin))))
        cost += sum(max(s1 - s0, 0.0) for s0, s1 in segs[r])
    _publish_fleet_obs(n, timeline, shed_mask=shed_mask, retries=retries,
                       rung_tl=rung_tl)
    return FleetReport(arrivals=arr, admissions=admissions,
                       completions=completions, latency=completions - arr,
                       assignment=assignment, routed_at=routed_at,
                       replica_cycles=cost,
                       replicas_max=int(max(c for _, c in timeline)),
                       timeline=timeline, shed_mask=shed_mask,
                       retries=retries, rung_timeline=rung_tl)
