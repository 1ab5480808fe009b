"""Simulated annealing — used by the DSE for (a) the intra-layer balancing
strategy (assigning input-channel/output-filter groups to SPEs so their
processing rates match, §IV) and (b) pipeline partitioning (§V-A.4)."""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np


def simulated_annealing(init_state, energy: Callable, neighbor: Callable,
                        *, steps: int = 2000, t0: float = 1.0,
                        t1: float = 1e-3, seed: int = 0):
    """Generic SA minimizer. Returns (best_state, best_energy, trace)."""
    rng = np.random.default_rng(seed)
    state = init_state
    e = energy(state)
    best, best_e = state, e
    trace = [e]
    for i in range(steps):
        t = t0 * (t1 / t0) ** (i / max(steps - 1, 1))
        cand = neighbor(state, rng)
        ce = energy(cand)
        if ce <= e or rng.random() < math.exp(-(ce - e) / max(t, 1e-12)):
            state, e = cand, ce
            if ce < best_e:
                best, best_e = cand, ce
        trace.append(e)
    return best, best_e, trace


def balance_assignment(rates: Sequence[float], n_engines: int,
                       *, steps: int = 2000, seed: int = 0) -> List[int]:
    """Assign work items with processing ``rates`` to ``n_engines`` engines,
    minimizing the max-engine load (the paper's Balancing Strategy: channels
    x filters onto i x o SPEs). Returns engine index per item."""
    rates = np.asarray(rates, dtype=float)
    n = len(rates)

    def energy(assign):
        loads = np.zeros(n_engines)
        np.add.at(loads, assign, rates)
        return loads.max() - loads.mean()

    def neighbor(assign, rng):
        a = assign.copy()
        a[rng.integers(n)] = rng.integers(n_engines)
        return a

    # greedy LPT init: largest rate -> least-loaded engine
    order = np.argsort(-rates)
    init = np.zeros(n, dtype=int)
    loads = np.zeros(n_engines)
    for idx in order:
        e = int(loads.argmin())
        init[idx] = e
        loads[e] += rates[idx]
    best, _, _ = simulated_annealing(init, energy, neighbor, steps=steps,
                                     seed=seed)
    return list(map(int, best))


def buffer_depths(rates: Sequence[float], window: int = 32,
                  slack: float = 1.5) -> List[int]:
    """The paper's Buffering Strategy heuristic (after [4]): size FIFOs to the
    moving-window variance of inter-engine rate mismatch."""
    rates = np.asarray(rates, dtype=float)
    mu = rates.mean() if len(rates) else 1.0
    # tokens a faster engine can run ahead within one window
    depth = np.ceil(slack * window * np.maximum(rates - mu, 0.0) / max(mu, 1e-9))
    return [int(max(2, d)) for d in depth]
