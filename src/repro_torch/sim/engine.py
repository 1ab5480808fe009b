"""Event-driven simulator of a partitioned dataflow deployment (DESIGN.md §13).

``simulate_partition`` replays a request ``Trace`` through the deployment a
``PartitionResult`` describes, as a chain of serial servers with finite
FIFO queues and blocking-after-service backpressure:

  * **spatial** mode (multi-chip ``TPUModel``): one server per resident
    stage (service time = request samples / the stage's DSE rate),
    interleaved with one server per ICI hop (service time = samples x the
    cut's per-sample transfer cycles — the same expression whose
    reciprocal ``partition_pipeline`` min's into ``steady_throughput``).
    Every internal queue holds at most ``q_depth`` waiting requests; a
    server that cannot hand off downstream *blocks* and stalls its own
    upstream — finite activation buffers, not infinite queues.
  * **temporal** mode (single-chip / FPGA reconfiguration schedule): one
    executor runs the partitions back to back per request and stalls for
    every partition *switch* (``reconfig_cycles``, or the ICI batch
    transfer on a multi-chip model forced temporal). A single resident
    partition incurs zero switch stalls — the same accounting
    ``partition_pipeline`` charges (P - 1 switches, none for P = 1).

The simulator is deterministic: all randomness lives in the (seeded)
trace, and simultaneous events resolve in FIFO insertion order.

**Sim-vs-analytic contract** (the subsystem's bit-exactness-style gate,
property-tested in ``tests/test_sim.py`` and gated in
``benchmarks/sim_bench.py``): under a backlogged trace the simulator's
steady completion rate equals the analytic model within ``SIM_TOL`` —
``steady_throughput`` in spatial mode, and the amortized temporal
``throughput`` in temporal mode when request size equals the partition
batch. Deterministic service admits no looser answer: the bottleneck
server is never starved or blocked at saturation, so windowed completion
spacing telescopes to the analytic bottleneck rate up to float
accumulation.
"""
from __future__ import annotations

import heapq
from bisect import insort
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.dse import PartitionResult, boundary_activations
from repro_torch.core.perf_model import (ACT_BYTES, HardwareModel, LayerCost,
                                   TPUModel)
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.faults import FaultTrace, NodeFaults
from repro_torch.sim.trace import Trace, backlogged_trace

# Documented sim-vs-analytic saturation tolerance (relative). Measured
# deviations are float-accumulation level (~1e-12); the slack is margin,
# not permission for modeling drift.
SIM_TOL = 1e-6


@dataclass
class SimReport:
    """What one simulated deployment did. Times are cycles; node arrays
    are indexed by ``node_names`` (stages and ICI links interleaved in
    pipeline order; a single ``executor`` node in temporal mode). The
    queue in front of node 0 is the unbounded admission queue — its
    occupancy is the request backlog."""
    mode: str
    node_names: List[str]
    arrivals: np.ndarray          # (N,)
    sizes: np.ndarray             # (N,) samples per request
    completions: np.ndarray       # (N,)
    latency: np.ndarray           # (N,) completion - arrival
    busy: np.ndarray              # (M,) service cycles per node
    blocked: np.ndarray           # (M,) backpressure-blocked cycles
    idle: np.ndarray              # (M,) neither serving nor blocked
    queue_mean: np.ndarray        # (M,) time-weighted mean occupancy
    queue_max: np.ndarray         # (M,) peak occupancy
    switch_stalls: int = 0        # partition switches charged (temporal)
    switch_stall_cycles: float = 0.0
    down: np.ndarray = None       # (M,) fault-displaced cycles (0 if no faults)

    def __post_init__(self):
        if self.down is None:
            self.down = np.zeros_like(self.busy)

    @property
    def completed(self) -> int:
        return len(self.completions)

    @property
    def total_samples(self) -> int:
        return int(self.sizes.sum())

    @property
    def horizon(self) -> float:
        """Cycles from t=0 to the last completion."""
        return float(self.completions.max()) if self.completed else 0.0

    @property
    def achieved_throughput(self) -> float:
        """Samples completed per cycle over the whole horizon (includes
        warmup fill and final drain — the deployment's actual rate)."""
        h = self.horizon
        return self.total_samples / h if h > 0 else 0.0

    @property
    def utilization(self) -> np.ndarray:
        """Per-node busy fraction of the horizon."""
        h = self.horizon
        return self.busy / h if h > 0 else np.zeros_like(self.busy)

    def latency_percentile(self, quantile: float) -> float:
        """Per-request latency percentile, ``quantile`` in 0..100."""
        if len(self.latency) == 0:
            raise ValueError(
                "latency_percentile on a report with zero completions")
        return float(np.percentile(self.latency, quantile))

    @property
    def p50(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99(self) -> float:
        return self.latency_percentile(99.0)

    def windowed_throughput(self, warmup: float = 0.5) -> float:
        """Steady completion rate: samples/cycle between the completion at
        the ``warmup`` fraction of the request count and the last one —
        drops pipeline-fill transients, the saturation measurement the
        sim-vs-analytic contract gates. Traces with fewer than two
        completions have no window; fall back to the whole-horizon rate."""
        if self.completed < 2:
            return self.achieved_throughput
        order = np.argsort(self.completions, kind="stable")
        C = self.completions[order]
        S = self.sizes[order].astype(np.float64)
        k0 = min(max(int(len(C) * warmup), 0), len(C) - 2)
        dt = float(C[-1] - C[k0])
        return float(S[k0 + 1:].sum()) / dt if dt > 0 else float("inf")


def _simulate_chain(arrivals: np.ndarray, sizes: np.ndarray,
                    service: Sequence[Callable[[int], float]],
                    caps: Sequence[int], engine: str = "calendar",
                    fx: Optional[Callable] = None):
    """Simulate a chain of M serial servers, FIFO queues of capacity
    ``caps[m]`` in front of each (``caps[0]`` is the unbounded admission
    queue), blocking-after-service handoff. Returns
    (completions, busy, blocked, idle, queue_mean, queue_max, down).

    ``fx`` is the optional fault hook (``faults.NodeFaults``): called as
    ``fx(node, t, base_dt) -> (occupation, down_part)`` at every service
    start, it injects crash/preemption windows (the displaced cycles land
    in ``down``) and straggler rate multipliers. Base service time stays
    a pure function of size, so the calendar engine's per-size memo keeps
    caching it; both engines call ``fx`` with identical triples, so
    faulted runs carry the same bit-identity contract as fault-free ones.
    ``fx=None`` leaves every pre-fault code path untouched (bit-identity
    with pre-fault builds is regression-gated in ``chaos_bench``).

    Two engines compute the identical schedule:

      * ``"heap"``     — the reference binary-heap event loop;
      * ``"calendar"`` — the fast path (default). The arrival stream IS
        the calendar: it is pre-sorted, so instead of seeding N heap
        entries the loop consumes it lazily through a cursor and keeps
        only the <= M in-flight finish events in a tiny sorted list.
        Single-server chains (temporal mode — the fleet policy search's
        hot path) drop to a vectorized busy-period scan; with faults the
        schedule is time-dependent, so M == 1 runs the general calendar
        loop instead.

    Bit-identity between the two is a hard contract (fuzz-gated in
    ``tests/test_sim.py`` and ``benchmarks/fleet_bench.py``): every float
    the calendar engine accumulates is produced by the same IEEE ops in
    the same order as the heap engine's, and simultaneous events resolve
    in the same deterministic insertion order."""
    if engine == "heap":
        return _simulate_chain_heap(arrivals, sizes, service, caps, fx)
    if engine != "calendar":
        raise ValueError(f"unknown engine {engine!r}")
    if len(service) == 1 and fx is None:
        return _simulate_single_server(arrivals, sizes, service)
    return _simulate_chain_calendar(arrivals, sizes, service, caps, fx)


def _simulate_chain_heap(arrivals: np.ndarray, sizes: np.ndarray,
                         service: Sequence[Callable[[int], float]],
                         caps: Sequence[int], fx: Optional[Callable] = None):
    """Reference event loop: one binary heap holding every pending event."""
    N, M = len(arrivals), len(service)
    queue = [deque() for _ in range(M)]
    serving: List[Optional[int]] = [None] * M
    held: List[Optional[int]] = [None] * M    # finished, blocked downstream
    block_t = [0.0] * M
    busy = [0.0] * M
    down = [0.0] * M
    blocked = [0.0] * M
    idle = [0.0] * M
    idle_t = [0.0] * M         # when the node last went idle
    is_idle = [True] * M       # nodes start idle at t=0
    completions = np.zeros(N, dtype=np.float64)
    q_int = [0.0] * M          # time-weighted occupancy integral
    q_t = [0.0] * M
    q_max = [0] * M

    # (time, seq, node, request): arrivals pre-seeded with node=-1 and
    # seq=request index; FINISH events get monotonically later seqs, so
    # simultaneous events resolve deterministically in insertion order
    events = [(float(arrivals[i]), i, -1, i) for i in range(N)]
    heapq.heapify(events)
    seq = N

    def q_touch(m: int, t: float) -> None:
        q_int[m] += len(queue[m]) * (t - q_t[m])
        q_t[m] = t

    def q_push(m: int, t: float, i: int) -> None:
        q_touch(m, t)
        queue[m].append(i)
        if len(queue[m]) > q_max[m]:
            q_max[m] = len(queue[m])

    def try_start(m: int, t: float) -> None:
        nonlocal seq
        if serving[m] is not None or held[m] is not None:
            return
        if not queue[m]:
            if not is_idle[m]:     # free with nothing to do -> idle
                is_idle[m] = True
                idle_t[m] = t
            return
        if is_idle[m]:
            idle[m] += t - idle_t[m]
            is_idle[m] = False
        q_touch(m, t)
        i = queue[m].popleft()
        serving[m] = i
        dt = service[m](int(sizes[i]))
        if fx is not None:
            dt, dn = fx(m, t, dt)
            busy[m] += dt - dn
            down[m] += dn
        else:
            busy[m] += dt
        heapq.heappush(events, (t + dt, seq, m, i))
        seq += 1
        if m > 0:
            unblock(m - 1, t)      # the pop freed a slot in queue[m]

    def unblock(m: int, t: float) -> None:
        if held[m] is None or len(queue[m + 1]) >= caps[m + 1]:
            return
        i = held[m]
        held[m] = None
        blocked[m] += t - block_t[m]
        q_push(m + 1, t, i)
        try_start(m + 1, t)
        try_start(m, t)

    while events:
        t, _, m, i = heapq.heappop(events)
        if m == -1:                               # arrival
            q_push(0, t, i)
            try_start(0, t)
            continue
        serving[m] = None                         # node m finished item i
        if m == M - 1:
            completions[i] = t
            try_start(m, t)
            continue
        if len(queue[m + 1]) < caps[m + 1]:
            q_push(m + 1, t, i)
            try_start(m + 1, t)
            try_start(m, t)
        else:
            held[m] = i                           # backpressure
            block_t[m] = t

    horizon = float(completions.max()) if N else 0.0
    for m in range(M):
        q_touch(m, horizon)
        if held[m] is not None:    # flush an interval still open at the end
            blocked[m] += horizon - block_t[m]
            held[m] = None
        elif serving[m] is None and is_idle[m]:
            idle[m] += horizon - idle_t[m]
            idle_t[m] = horizon
    q_mean = [q_int[m] / horizon if horizon > 0 else 0.0 for m in range(M)]
    return completions, busy, blocked, idle, q_mean, q_max, down


def _simulate_single_server(arrivals: np.ndarray, sizes: np.ndarray,
                            service: Sequence[Callable[[int], float]]):
    """M == 1 calendar fast path: one FIFO server, no blocking possible,
    so the whole schedule is the busy-period recurrence
    ``S[i] = max(A[i], F[i-1]); F[i] = S[i] + svc[i]`` — evaluated one
    busy period at a time with ``np.add.accumulate``, whose elementwise
    partial sums are the *same sequential float adds* the event loop
    performs (bit-exact; ``np.sum``'s pairwise tree would not be)."""
    N = len(arrivals)
    if N == 0:
        return (np.zeros(0, dtype=np.float64),
                [0.0], [0.0], [0.0], [0.0], [0], [0.0])
    A = np.asarray(arrivals, dtype=np.float64)
    uniq, inv = np.unique(np.asarray(sizes, dtype=np.int64),
                          return_inverse=True)
    svc_fn = service[0]
    svc = np.array([svc_fn(int(s)) for s in uniq], dtype=np.float64)[inv]

    S = np.empty(N)
    F = np.empty(N)
    i0 = 0
    while i0 < N:
        # assume the busy period starting at i0 never ends, then cut at
        # the first arrival strictly later than the running F. Seeding
        # the accumulate with A[i0] keeps every add in the engine's
        # left-to-right order (A + s0) + s1 ..., not A + (s0 + s1).
        Fc = np.add.accumulate(
            np.concatenate([A[i0:i0 + 1], svc[i0:]]))[1:]
        gap = A[i0 + 1:] > Fc[:-1]
        k = int(np.argmax(gap)) + i0 + 1 if gap.any() else N
        S[i0] = A[i0]
        S[i0 + 1:k] = Fc[:k - i0 - 1]
        F[i0:k] = Fc[:k - i0]
        i0 = k
    horizon = float(F[-1])
    busy = float(np.add.accumulate(svc)[-1])
    # idle accrues at each service start that follows a gap; S - F_prev is
    # +0.0 within a busy period, and adding +0.0 to a non-negative
    # accumulator is a bitwise no-op, so the skips need no masking
    idle = float(np.add.accumulate(
        np.concatenate([S[:1], S[1:] - F[:-1]]))[-1])

    # queue-occupancy integral in exact engine touch order, reconstructed
    # by counting rather than sorting. A pop lands inside its own arrival
    # cascade (push_j then immediately pop_j) iff the server was strictly
    # free at A[j]; otherwise it belongs to the triggering finish event,
    # which sorts after every same-time arrival push (arrival seqs < N <=
    # finish seqs in the heap engine). Pops are FIFO, so pop j has exactly
    # j pops before it; searchsorted supplies the push/pop interleaving.
    own = np.empty(N, dtype=bool)
    own[0] = True
    own[1:] = A[1:] > F[:-1]
    pushes_before_pop = np.where(
        own, np.arange(N) + 1, np.searchsorted(A, S, side="right"))
    own_before = np.concatenate([[0], np.cumsum(own)])[:-1]
    pops_before_push = own_before + np.searchsorted(S[~own], A, side="left")
    idx_pop = np.arange(N) + pushes_before_pop
    idx_push = np.arange(N) + pops_before_push
    times = np.empty(2 * N)
    deltas = np.empty(2 * N, dtype=np.int64)
    times[idx_push] = A
    times[idx_pop] = S
    deltas[idx_push] = 1
    deltas[idx_pop] = -1
    occ = np.cumsum(deltas)
    occ_before = np.concatenate([[0], occ[:-1]])
    dt = np.concatenate([[0.0], np.diff(times)])
    q_int = float(np.add.accumulate(occ_before * dt)[-1])
    q_mean = q_int / horizon if horizon > 0 else 0.0
    return F, [busy], [0.0], [idle], [q_mean], [int(occ.max())], [0.0]


def _simulate_chain_calendar(arrivals: np.ndarray, sizes: np.ndarray,
                             service: Sequence[Callable[[int], float]],
                             caps: Sequence[int],
                             fx: Optional[Callable] = None):
    """General-M calendar engine. The heap held N pre-seeded arrivals plus
    <= M finish events; here the sorted arrival array is consumed through
    a cursor and only the finish events live in a bisect-insort'd list.
    The heap's ``try_start``/``unblock`` cascades are inlined with their
    provable no-ops dropped: ``unblock``'s ``try_start(m+1)`` fires right
    after node m+1 started serving (no-op), and an upstream ripple can
    only propagate toward node 0. Bookkeeping ops (and therefore every
    accumulated float) stay in the heap engine's exact order."""
    N, M = len(arrivals), len(service)
    arr = arrivals.tolist() if hasattr(arrivals, "tolist") else list(arrivals)
    szs = sizes.tolist() if hasattr(sizes, "tolist") else [int(s) for s in sizes]
    svc_memo: List[dict] = [dict() for _ in range(M)]

    queue = [deque() for _ in range(M)]
    q_append = [q.append for q in queue]
    q_popleft = [q.popleft for q in queue]
    qlen = [0] * M
    serving = [False] * M
    held = [-1] * M            # request index, -1 = not held
    block_t = [0.0] * M
    busy = [0.0] * M
    down = [0.0] * M
    blocked = [0.0] * M
    idle = [0.0] * M
    idle_t = [0.0] * M
    is_idle = [True] * M
    completions = [0.0] * N
    q_int = [0.0] * M
    q_t = [0.0] * M
    q_max = [0] * M

    pend: List[tuple] = []     # sorted in-flight finish events, <= M
    seq = N
    caps_l = list(caps)
    last = M - 1
    ai = 0
    INF = float("inf")

    while True:
        at = arr[ai] if ai < N else INF
        if pend and pend[0][0] < at:
            t, _, m, i = pend.pop(0)
            serving[m] = False
            if m == last:
                completions[i] = t
                if qlen[m] and held[m] < 0:        # try_start(m)
                    q_int[m] += qlen[m] * (t - q_t[m])
                    q_t[m] = t
                    j = q_popleft[m]()
                    qlen[m] -= 1
                    serving[m] = True
                    sz = szs[j]
                    memo = svc_memo[m]
                    dt = memo.get(sz)
                    if dt is None:
                        dt = memo[sz] = service[m](sz)
                    if fx is not None:
                        dt, dn = fx(m, t, dt)
                        busy[m] += dt - dn
                        down[m] += dn
                    else:
                        busy[m] += dt
                    insort(pend, (t + dt, seq, m, j))
                    seq += 1
                    w = m
                    while w > 0:                   # upstream ripple
                        k = w - 1
                        if held[k] < 0 or qlen[w] >= caps_l[w]:
                            break
                        h = held[k]
                        held[k] = -1
                        blocked[k] += t - block_t[k]
                        q_int[w] += qlen[w] * (t - q_t[w])
                        q_t[w] = t
                        q_append[w](h)
                        qlen[w] += 1
                        if qlen[w] > q_max[w]:
                            q_max[w] = qlen[w]
                        if qlen[k]:
                            q_int[k] += qlen[k] * (t - q_t[k])
                            q_t[k] = t
                            j = q_popleft[k]()
                            qlen[k] -= 1
                            serving[k] = True
                            sz = szs[j]
                            memo = svc_memo[k]
                            dt = memo.get(sz)
                            if dt is None:
                                dt = memo[sz] = service[k](sz)
                            if fx is not None:
                                dt, dn = fx(k, t, dt)
                                busy[k] += dt - dn
                                down[k] += dn
                            else:
                                busy[k] += dt
                            insort(pend, (t + dt, seq, k, j))
                            seq += 1
                            w = k
                        else:                      # unheld, nothing queued
                            is_idle[k] = True
                            idle_t[k] = t
                            break
                else:
                    is_idle[m] = True
                    idle_t[m] = t
                continue
            n = m + 1
            if qlen[n] < caps_l[n]:                # q_push(n) handoff
                q_int[n] += qlen[n] * (t - q_t[n])
                q_t[n] = t
                q_append[n](i)
                qlen[n] += 1
                if qlen[n] > q_max[n]:
                    q_max[n] = qlen[n]
                if not serving[n] and held[n] < 0:  # try_start(n)
                    if is_idle[n]:
                        idle[n] += t - idle_t[n]
                        is_idle[n] = False
                    q_int[n] += qlen[n] * (t - q_t[n])
                    q_t[n] = t
                    j = q_popleft[n]()
                    qlen[n] -= 1
                    serving[n] = True
                    sz = szs[j]
                    memo = svc_memo[n]
                    dt = memo.get(sz)
                    if dt is None:
                        dt = memo[sz] = service[n](sz)
                    if fx is not None:
                        dt, dn = fx(n, t, dt)
                        busy[n] += dt - dn
                        down[n] += dn
                    else:
                        busy[n] += dt
                    insort(pend, (t + dt, seq, n, j))
                    seq += 1
                    # unblock(m): held[m] < 0 on a finish event -> no-op
                if qlen[m] and held[m] < 0:        # try_start(m)
                    q_int[m] += qlen[m] * (t - q_t[m])
                    q_t[m] = t
                    j = q_popleft[m]()
                    qlen[m] -= 1
                    serving[m] = True
                    sz = szs[j]
                    memo = svc_memo[m]
                    dt = memo.get(sz)
                    if dt is None:
                        dt = memo[sz] = service[m](sz)
                    if fx is not None:
                        dt, dn = fx(m, t, dt)
                        busy[m] += dt - dn
                        down[m] += dn
                    else:
                        busy[m] += dt
                    insort(pend, (t + dt, seq, m, j))
                    seq += 1
                    w = m
                    while w > 0:                   # upstream ripple
                        k = w - 1
                        if held[k] < 0 or qlen[w] >= caps_l[w]:
                            break
                        h = held[k]
                        held[k] = -1
                        blocked[k] += t - block_t[k]
                        q_int[w] += qlen[w] * (t - q_t[w])
                        q_t[w] = t
                        q_append[w](h)
                        qlen[w] += 1
                        if qlen[w] > q_max[w]:
                            q_max[w] = qlen[w]
                        if qlen[k]:
                            q_int[k] += qlen[k] * (t - q_t[k])
                            q_t[k] = t
                            j = q_popleft[k]()
                            qlen[k] -= 1
                            serving[k] = True
                            sz = szs[j]
                            memo = svc_memo[k]
                            dt = memo.get(sz)
                            if dt is None:
                                dt = memo[sz] = service[k](sz)
                            if fx is not None:
                                dt, dn = fx(k, t, dt)
                                busy[k] += dt - dn
                                down[k] += dn
                            else:
                                busy[k] += dt
                            insort(pend, (t + dt, seq, k, j))
                            seq += 1
                            w = k
                        else:
                            is_idle[k] = True
                            idle_t[k] = t
                            break
                else:
                    is_idle[m] = True
                    idle_t[m] = t
            else:
                held[m] = i                        # backpressure
                block_t[m] = t
        elif ai < N:                               # arrival -> q_push(0)
            t = at
            i = ai
            ai += 1
            q_int[0] += qlen[0] * (t - q_t[0])
            q_t[0] = t
            q_append[0](i)
            qlen[0] += 1
            if qlen[0] > q_max[0]:
                q_max[0] = qlen[0]
            if not serving[0] and held[0] < 0:     # try_start(0)
                if is_idle[0]:
                    idle[0] += t - idle_t[0]
                    is_idle[0] = False
                q_int[0] += qlen[0] * (t - q_t[0])
                q_t[0] = t
                j = q_popleft[0]()
                qlen[0] -= 1
                serving[0] = True
                sz = szs[j]
                memo = svc_memo[0]
                dt = memo.get(sz)
                if dt is None:
                    dt = memo[sz] = service[0](sz)
                if fx is not None:
                    dt, dn = fx(0, t, dt)
                    busy[0] += dt - dn
                    down[0] += dn
                else:
                    busy[0] += dt
                insort(pend, (t + dt, seq, 0, j))
                seq += 1
        else:
            break

    completions = np.asarray(completions, dtype=np.float64)
    horizon = float(completions.max()) if N else 0.0
    for m in range(M):
        q_int[m] += qlen[m] * (horizon - q_t[m])
        q_t[m] = horizon
        if held[m] >= 0:           # flush an interval still open at the end
            blocked[m] += horizon - block_t[m]
            held[m] = -1
        elif not serving[m] and is_idle[m]:
            idle[m] += horizon - idle_t[m]
            idle_t[m] = horizon
    q_mean = [q_int[m] / horizon if horizon > 0 else 0.0 for m in range(M)]
    return completions, busy, blocked, idle, q_mean, q_max, down


def simulate_partition(layers: Sequence[LayerCost], hw: HardwareModel,
                       partition: PartitionResult, trace: Trace, *,
                       q_depth: int = 8, reconfig_cycles: float = 5e7,
                       mode: str = "auto", engine: str = "calendar",
                       faults: Optional[FaultTrace] = None) -> SimReport:
    """Simulate ``trace`` through the deployment ``partition`` describes
    (stage rates from its per-stage DSE designs, ICI hops priced at the
    cuts' boundary activations). ``mode="auto"`` picks spatial for a
    multi-chip ``TPUModel`` — the schedule such a slice actually runs —
    and temporal otherwise; ``reconfig_cycles`` is the temporal switch
    stall, matching ``partition_pipeline``'s accounting. ``engine``
    selects the event engine (``"calendar"`` default, ``"heap"``
    reference — bit-identical by contract, see ``_simulate_chain``).

    ``faults`` injects a deterministic ``FaultTrace`` (DESIGN.md §17):
    stage crash/preemption windows park the server (displaced cycles in
    ``SimReport.down``), straggler windows divide its rate, ``ici`` rows
    degrade the hop servers (spatial mode). ``None`` — or an *empty*
    trace — leaves every pre-fault code path untouched."""
    rates = [float(r) for r in partition.part_throughput]
    cuts = list(partition.cuts)
    if not rates or min(rates) <= 0:
        raise ValueError("partition must carry positive part_throughput")
    if q_depth < 1:
        raise ValueError("q_depth must be >= 1")
    multi_chip = isinstance(hw, TPUModel) and hw.chips > 1
    if mode == "auto":
        mode = "spatial" if multi_chip else "temporal"
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown mode {mode!r}")

    arrivals = np.asarray(trace.arrivals, dtype=np.float64)
    sizes = np.asarray(trace.sizes, dtype=np.int64)
    N = len(arrivals)
    switch_stalls = 0
    stall_cycles = 0.0

    if mode == "spatial":
        service: List[Callable[[int], float]] = []
        names: List[str] = []
        for s, r in enumerate(rates):
            service.append(lambda sz, r=r: sz / r)
            names.append(f"stage{s}")
            if s < len(rates) - 1:
                hop = hw.ici_transfer_cycles(
                    boundary_activations(layers, cuts[s]) * ACT_BYTES)
                service.append(lambda sz, hop=hop: sz * hop)
                names.append(f"ici{s}")
        caps = [N + 1] + [q_depth] * (len(service) - 1)
    else:
        def switch_of(sz: int) -> float:
            if multi_chip:
                return sum(hw.ici_transfer_cycles(
                    sz * boundary_activations(layers, c) * ACT_BYTES)
                    for c in cuts)
            return sum(reconfig_cycles for _ in cuts)

        def service_one(sz: int) -> float:
            # same fold order as partition_pipeline's time_per_batch:
            # sum of stage times, then the sum of switch stalls
            return sum(sz / r for r in rates) + switch_of(sz)

        service = [service_one]
        names = ["executor"]
        caps = [N + 1]
        if cuts:
            switch_stalls = len(cuts) * N
            stall_cycles = float(sum(switch_of(int(s)) for s in sizes))

    fx = None
    if faults is not None and not faults.empty:
        fx = NodeFaults.for_chain(faults, len(rates), mode)
    completions, busy, blocked, idle, q_mean, q_max, down = _simulate_chain(
        arrivals, sizes, service, caps, engine=engine, fx=fx)
    tr = get_tracer()
    if tr.enabled:
        # no per-event cost even when tracing: a full chain serves every
        # request once per node, so the event count (N arrivals + N*M
        # service finishes) is derivable after the fact
        M = len(service)
        fast = engine == "calendar" and M == 1 and fx is None
        tr.count("sim.runs")
        tr.count(f"sim.mode.{mode}")
        tr.count("sim.engine.single_server" if fast
                 else f"sim.engine.{engine}")
        tr.count("sim.requests", N)
        tr.count("sim.events", N * (M + 1))
    return SimReport(mode=mode, node_names=names, arrivals=arrivals,
                     sizes=sizes, completions=completions,
                     latency=completions - arrivals,
                     busy=np.asarray(busy), blocked=np.asarray(blocked),
                     idle=np.asarray(idle),
                     queue_mean=np.asarray(q_mean),
                     queue_max=np.asarray(q_max, dtype=np.int64),
                     switch_stalls=switch_stalls,
                     switch_stall_cycles=stall_cycles,
                     down=np.asarray(down, dtype=np.float64))


def saturation_throughput(layers: Sequence[LayerCost], hw: HardwareModel,
                          partition: PartitionResult, *,
                          n_requests: int = 96, size: Optional[int] = None,
                          q_depth: int = 8, reconfig_cycles: float = 5e7,
                          mode: str = "auto", warmup: float = 0.5) -> float:
    """The simulator's saturation rate: drive a backlogged trace (every
    request queued at t=0) and measure the post-warmup completion rate.
    This is the left side of the sim-vs-analytic contract: within
    ``SIM_TOL`` of ``partition.steady_throughput`` (spatial) or of
    ``partition.throughput`` when ``size`` is the partition batch
    (temporal)."""
    sz = int(partition.batch if size is None else size)
    rep = simulate_partition(layers, hw, partition,
                             backlogged_trace(n_requests, sz),
                             q_depth=q_depth,
                             reconfig_cycles=reconfig_cycles, mode=mode)
    return rep.windowed_throughput(warmup)
