"""Seeded, deterministic fault scenarios for the deployment layers
(DESIGN.md §17).

A ``FaultTrace`` is the failure-side twin of ``trace.Trace``: where a
``Trace`` is the offered load, a ``FaultTrace`` is the offered *damage* —
a fixed, replayable schedule of

  * **crashes** — ``(unit, t_down, t_up)`` windows during which a unit is
    gone. Consumed by ``simulate_fleet`` as replica crash/restart windows
    (in-flight requests re-enqueue to the central hold queue with a retry
    budget) and by ``simulate_partition`` as chip-preemption windows (the
    stage's server starts no new service inside the window; displaced
    time lands in ``SimReport.down``).
  * **slowdowns** — ``(unit, t0, t1, rate_mult)`` transient straggler
    windows: the unit's service *rate* is multiplied by ``rate_mult``
    (0.5 = half speed) for service begun inside the window. Concurrent
    windows on one unit compound multiplicatively.
  * **ici** — ``(hop, t0, t1, rate_mult)`` ICI-link degradation windows,
    applied to the hop servers of a spatial ``simulate_partition`` chain.

Every field is a plain float array, so a ``FaultTrace`` carries the same
reproducibility contract as the request traces: equal arrays ⇒ equal
simulations, byte for byte, on both event engines. ``inject_faults`` is
the seeded generator (Poisson fault arrivals, exponential outage/straggle
durations); ``zero_fault_trace``/``FaultTrace.none()`` is the explicit
no-op scenario — consuming it is bit-identical to passing ``faults=None``
(regression-gated in ``benchmarks/chaos_bench.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


def _as_windows(rows, width: int, what: str) -> np.ndarray:
    """Normalize a window table to a sorted (K, width) float64 array."""
    a = np.asarray(rows if rows is not None else [], dtype=np.float64)
    if a.size == 0:
        return np.zeros((0, width), dtype=np.float64)
    a = np.atleast_2d(a)
    if a.shape[1] != width:
        raise ValueError(f"{what} rows must have {width} columns "
                         f"(got shape {a.shape})")
    if np.any(a[:, 0] < 0):
        raise ValueError(f"{what} unit indices must be >= 0")
    if np.any(a[:, 2] <= a[:, 1]):
        raise ValueError(f"{what} windows need t_end > t_start")
    if width == 4 and np.any(a[:, 3] <= 0):
        raise ValueError(f"{what} rate multipliers must be positive")
    # deterministic canonical order: (t_start, unit)
    order = np.lexsort((a[:, 0], a[:, 1]))
    return a[order]


@dataclass
class FaultTrace:
    """One deterministic fault scenario (see module docstring). ``kind``
    tags the generator for reports, mirroring ``Trace.kind``."""
    crashes: np.ndarray = None        # (K, 3) [unit, t_down, t_up]
    slowdowns: np.ndarray = None      # (J, 4) [unit, t0, t1, rate_mult]
    ici: np.ndarray = None            # (I, 4) [hop, t0, t1, rate_mult]
    kind: str = "replay"

    def __post_init__(self):
        self.crashes = _as_windows(self.crashes, 3, "crashes")
        self.slowdowns = _as_windows(self.slowdowns, 4, "slowdowns")
        self.ici = _as_windows(self.ici, 4, "ici")

    @property
    def empty(self) -> bool:
        """True iff the scenario injects nothing — consumers take their
        exact pre-fault code paths (bit-identity contract)."""
        return (len(self.crashes) == 0 and len(self.slowdowns) == 0
                and len(self.ici) == 0)

    @classmethod
    def none(cls) -> "FaultTrace":
        return cls(kind="none")

    def down_windows(self, unit: int) -> List[Tuple[float, float]]:
        """Merged, sorted crash windows of one unit."""
        rows = self.crashes[self.crashes[:, 0] == unit]
        return _merge([(float(a), float(b)) for _, a, b in rows])

    def slow_windows(self, unit: int) -> List[Tuple[float, float, float]]:
        rows = self.slowdowns[self.slowdowns[:, 0] == unit]
        return [(float(a), float(b), float(m)) for _, a, b, m in rows]

    def ici_windows(self, hop: int) -> List[Tuple[float, float, float]]:
        rows = self.ici[self.ici[:, 0] == hop]
        return [(float(a), float(b), float(m)) for _, a, b, m in rows]


def _merge(ws: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping [a, b) windows (input sorted by start)."""
    out: List[Tuple[float, float]] = []
    for a, b in ws:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


#: Restart-time sentinel for "never comes back": crash windows whose
#: ``t_up`` is at or beyond this are terminal — ``simulate_fleet`` emits
#: no restart event for them (held requests shed at drain instead of
#: completing at an astronomical clock).
NEVER = 1e30


def zero_fault_trace() -> FaultTrace:
    """The explicit no-op scenario; consuming it is bit-identical to
    ``faults=None`` (gated in ``chaos_bench``)."""
    return FaultTrace.none()


def replica_loss(unit: int, t_down: float,
                 t_up: float = float("inf")) -> FaultTrace:
    """The canonical chaos scenario: one unit crashes at ``t_down`` and
    (optionally) restarts at ``t_up`` — e.g. one replica lost at peak
    load, the configuration the failure-aware SLO search is gated on."""
    if not np.isfinite(t_up):
        t_up = NEVER       # terminal: never restarts, still a window
    return FaultTrace(crashes=[[float(unit), float(t_down), float(t_up)]],
                      kind="replica_loss")


def inject_faults(n_units: int, horizon: float, *,
                  crash_rate: float = 0.0, restart_mean: float = 1e6,
                  slow_rate: float = 0.0, slow_mean: float = 1e6,
                  slow_factor: float = 0.5,
                  n_hops: int = 0, ici_rate: float = 0.0,
                  ici_mean: float = 1e6, ici_factor: float = 0.5,
                  seed: int = 0) -> FaultTrace:
    """Seeded fault generator: per-unit Poisson fault arrivals over
    ``[0, horizon)`` with exponential outage/straggle durations —
    deterministic in ``seed`` (same reproducibility contract as the
    request-trace generators). ``*_rate`` are events per cycle per unit;
    ``*_mean`` the mean window length; ``slow_factor``/``ici_factor`` the
    service-rate multiplier inside a straggler/ICI window."""
    if n_units < 1:
        raise ValueError("n_units must be >= 1")
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    if min(restart_mean, slow_mean, ici_mean) <= 0:
        raise ValueError("mean window lengths must be positive")
    if not (0 < slow_factor) or not (0 < ici_factor):
        raise ValueError("rate factors must be positive")
    rng = np.random.default_rng(seed)
    crashes, slows, ici = [], [], []
    for u in range(n_units):
        t = 0.0
        while crash_rate > 0:
            t += rng.exponential(1.0 / crash_rate)
            if t >= horizon:
                break
            crashes.append([u, t, t + rng.exponential(restart_mean)])
            t = crashes[-1][2]
        t = 0.0
        while slow_rate > 0:
            t += rng.exponential(1.0 / slow_rate)
            if t >= horizon:
                break
            slows.append([u, t, t + rng.exponential(slow_mean), slow_factor])
            t = slows[-1][2]
    for h in range(n_hops):
        t = 0.0
        while ici_rate > 0:
            t += rng.exponential(1.0 / ici_rate)
            if t >= horizon:
                break
            ici.append([h, t, t + rng.exponential(ici_mean), ici_factor])
            t = ici[-1][2]
    return FaultTrace(crashes=crashes, slowdowns=slows, ici=ici,
                      kind="injected")


class NodeFaults:
    """Per-node fault evaluator for the chain engines: down windows delay
    the start of service begun inside them (the displaced cycles are the
    node's ``down`` time), straggler windows divide the base service time
    by the product of the rate multipliers active at the *effective*
    start. Both engines call it with the same ``(node, t, base_dt)``
    triples, so faulted runs stay bit-identical heap-vs-calendar — the
    same contract the fault-free engines carry."""

    def __init__(self, down: Sequence[List[Tuple[float, float]]],
                 slow: Sequence[List[Tuple[float, float, float]]]):
        self.down = [list(w) for w in down]
        self.slow = [list(w) for w in slow]

    @classmethod
    def for_chain(cls, faults: FaultTrace, n_stages: int,
                  mode: str) -> "NodeFaults":
        """Map a ``FaultTrace`` onto ``simulate_partition``'s node chain.
        Spatial mode interleaves stages and ICI hops (stage ``s`` at node
        ``2s``, hop ``h`` at node ``2h+1``): crashes/slowdowns hit their
        stage's server, ``ici`` windows hit the hop servers. Temporal mode
        has one executor: every unit's crash and slowdown windows apply to
        it (the single resident program shares the chip); hop windows do
        not (switch stalls are priced analytically)."""
        if mode == "temporal":
            down = [_merge(sorted(
                (float(a), float(b)) for _, a, b in faults.crashes))]
            slow = [[(float(a), float(b), float(m))
                     for _, a, b, m in faults.slowdowns]]
            return cls(down, slow)
        M = 2 * n_stages - 1
        down: List[List[Tuple[float, float]]] = [[] for _ in range(M)]
        slow: List[List[Tuple[float, float, float]]] = [[] for _ in range(M)]
        for s in range(n_stages):
            down[2 * s] = faults.down_windows(s)
            slow[2 * s] = faults.slow_windows(s)
        for h in range(n_stages - 1):
            slow[2 * h + 1] = faults.ici_windows(h)
        return cls(down, slow)

    def __call__(self, m: int, t: float, base_dt: float
                 ) -> Tuple[float, float]:
        """(total occupation, down part) for service begun at ``t``."""
        t0 = t
        down = 0.0
        moved = True
        while moved:             # a delayed start may land in a later window
            moved = False
            for a, b in self.down[m]:
                if a <= t0 < b:
                    down += b - t0
                    t0 = b
                    moved = True
        mult = 1.0
        for a, b, r in self.slow[m]:
            if a <= t0 < b:
                mult *= r
        dt = base_dt if mult == 1.0 else base_dt / mult
        return down + dt, down
