"""Accelerator Design-Space Exploration (§V-A of the paper).

Implements, verbatim in structure:
  1. performance modeling (Eq. 1–3, in ``core.perf_model``),
  2. resource-constrained rate balancing (Eq. 4–5),
  3. resource-constrained incrementing (start minimal; repeatedly grow the
     slowest layer, then re-balance, until the budget R is exhausted),
  4. partitioning & reconfiguration (exact DP over pipeline split points on
     a memoized per-segment Pareto-frontier table; on TPU "full
     reconfiguration" = switching the mesh program between partitions —
     or, multi-chip, the ICI boundary transfer — amortized by batch size;
     the paper's SA loop is retained as ``partition_pipeline_sa``).

Every search also returns its full (resource, throughput) ``ParetoFrontier``
with materializable per-point design state (DESIGN.md §10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from itertools import repeat
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import _dse_ckernel
from repro_torch.core.annealing import simulated_annealing
from repro_torch.core.perf_model import (ACT_BYTES, DesignPoint, HardwareModel,
                                   LayerCost, LayerVectors, TPUModel,
                                   pipeline_throughput, t_cycles)
from repro_torch.obs.trace import Counters

# engine-dispatch telemetry (DESIGN.md §18): which backend each DSE
# invocation actually ran — ``flat``/``grouped`` for the serial greedy,
# ``compiled``/``lockstep`` for the batched engines. Always-on plain dict
# increments (one per whole engine run, nothing per iteration); the search
# flight recorder snapshots deltas per trial.
ENGINE_DISPATCH = Counters("flat", "grouped", "compiled", "lockstep")


def engine_dispatch_stats() -> Dict[str, int]:
    """Cumulative engine-dispatch counts for this process."""
    return ENGINE_DISPATCH.as_dict()


def reset_engine_dispatch() -> None:
    for k in ENGINE_DISPATCH.as_dict():
        ENGINE_DISPATCH.set(k, 0)


@dataclass
class ParetoFrontier:
    """The non-dominated (resource, throughput) set traced by one DSE run.

    Both arrays are sorted strictly increasing, so the frontier *is* the
    budget -> throughput function of the search: ``best_under(b)`` is a
    binary search, and ``materialize(k)`` rebuilds the concrete per-layer
    ``DesignPoint`` list of point ``k`` from the captured design state —
    no re-run of the greedy loop. Interior points are as-searched states
    on the growth path (strict-balanced); the last point is the final
    Eq. 4-trimmed search result, so ``best_under(search_budget)`` equals
    the ``DSEResult`` exactly (DESIGN.md §10).
    """
    res: np.ndarray               # (K,) float64, strictly increasing
    thr: np.ndarray               # (K,) float64, strictly increasing
    spe: np.ndarray               # (K, L) int64 design-state snapshots
    n: np.ndarray                 # (K, L) int64

    def __len__(self) -> int:
        return len(self.res)

    def point(self, k: int) -> Tuple[float, float]:
        return float(self.res[k]), float(self.thr[k])

    def best_under(self, budget: float) -> Optional[int]:
        """Index of the max-throughput point with resource <= budget, or
        None when even the cheapest point exceeds the budget."""
        k = int(np.searchsorted(self.res, budget, side="right")) - 1
        return k if k >= 0 else None

    def select(self, score: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> int:
        """Argmax of a vectorized ``score(res, thr)`` over frontier points —
        how Eq. 6 consumers pick a trade-off point without re-searching."""
        return int(np.argmax(score(self.res, self.thr)))

    def materialize(self, k: int) -> List[DesignPoint]:
        return _designs_from(self.spe[k], self.n[k])


def _frontier_keep(res_pts: List[float], thr_pts: List[float]) -> List[int]:
    """Skyline indices of the recorded search path. The last input point is
    the final (Eq. 4-trimmed) result: it is made the canonical representative
    of its throughput level (using the DSE's own 1e-9 bottleneck tolerance)
    so near-duplicate as-searched states never shadow it under
    ``best_under``. Vectorized; (res, -thr) ordering ties resolve to the
    earliest row both here (stable lexsort) and in the scalar original
    (stable list sort), so the kept set is unchanged."""
    r = np.asarray(res_pts, dtype=np.float64)
    t = np.asarray(thr_pts, dtype=np.float64)
    f_res, f_thr = r[-1], t[-1]
    lo, hi = f_thr * (1 - 1e-9), f_thr * (1 + 1e-9)
    m = ~(((t >= lo) & (t <= hi)) | ((r >= f_res) & (t <= hi)))
    m[-1] = True
    idx = np.nonzero(m)[0]
    idx = idx[np.lexsort((-t[idx], r[idx]))]
    tt = t[idx]
    run_max = np.maximum.accumulate(
        np.concatenate(([-np.inf], tt[:-1])))
    return idx[tt > run_max].tolist()


def _build_frontier(res_pts: List[float], thr_pts: List[float],
                    states: List[Tuple[List[int], List[int]]]) -> ParetoFrontier:
    keep = _frontier_keep(res_pts, thr_pts)
    L = len(states[-1][0])
    return ParetoFrontier(
        res=np.array([res_pts[i] for i in keep], dtype=np.float64),
        thr=np.array([thr_pts[i] for i in keep], dtype=np.float64),
        spe=np.array([states[i][0] for i in keep],
                     dtype=np.int64).reshape(len(keep), L),
        n=np.array([states[i][1] for i in keep],
                   dtype=np.int64).reshape(len(keep), L))


@dataclass
class DSEResult:
    designs: List[DesignPoint]
    throughput: float             # samples/cycle (Eq. 3)
    resource: float               # total resource units (DSPs / tile-lanes)
    throughput_per_res: float
    trace: List[Tuple[float, float]]  # (resource, throughput) per increment
    frontier: Optional[ParetoFrontier] = None
    theta_r: float = 0.0          # peak bottleneck rate before the final
    #                               Eq. 4 trim — the DSECache warm-start
    #                               certificate bound (DESIGN.md §12)

    def images_per_s(self, hw: HardwareModel) -> float:
        return self.throughput * hw.freq


def _grow_options(l: LayerCost, d: DesignPoint, hw: HardwareModel):
    """Candidate increments for one layer: more MACs/SPE or more SPEs."""
    opts = []
    if d.macs_per_spe < hw.max_n(l):
        opts.append(replace(d, macs_per_spe=min(d.macs_per_spe * 2, hw.max_n(l))))
    if d.spe < hw.max_spe(l):
        opts.append(replace(d, spe=min(d.spe * 2, hw.max_spe(l))))
    return opts


def rate_balance_ref(layers: Sequence[LayerCost], designs: List[DesignPoint],
                     hw: HardwareModel, *, protect: Optional[set] = None,
                     strict: bool = False) -> List[DesignPoint]:
    """Reference (scalar, per-layer-loop) Eq. 4–5 implementation. Kept
    verbatim for equivalence testing against the vectorized ``rate_balance``;
    see that function for the semantics."""
    protect = protect or set()
    theta_r = pipeline_throughput(layers, designs, hw)
    lo = theta_r * (1 + 1e-9) if strict else theta_r * (1 - 1e-12)
    balanced: List[DesignPoint] = []
    for i, (l, d) in enumerate(zip(layers, designs)):
        if i in protect:
            balanced.append(d)
            continue
        best = d
        changed = True
        while changed:
            changed = False
            for cand in (replace(best, macs_per_spe=max(1, best.macs_per_spe // 2)),
                         replace(best, spe=max(1, best.spe // 2))):
                if (cand.spe, cand.macs_per_spe) == (best.spe, best.macs_per_spe):
                    continue
                if hw.layer_throughput(l, cand) >= lo:
                    best = cand
                    changed = True
                    break
        balanced.append(best)
    return balanced


# --------------------------------------------------------------------- #
# Vectorized engine (DESIGN.md §7): the design state is two small int
# vectors (spe, macs_per_spe) — designs only ever double/halve — operated
# on as flat arrays instead of per-layer dataclass lists.
# --------------------------------------------------------------------- #
def _design_arrays(designs: Sequence[DesignPoint]):
    spe = np.array([d.spe for d in designs], dtype=np.int64)
    n = np.array([d.macs_per_spe for d in designs], dtype=np.int64)
    return spe, n


def _designs_from(spe: np.ndarray, n: np.ndarray) -> List[DesignPoint]:
    return [DesignPoint(int(s), int(m)) for s, m in zip(spe, n)]


def _balance_arrays(hw: HardwareModel, lv: LayerVectors, spe: np.ndarray,
                    n: np.ndarray, protect: np.ndarray, strict: bool):
    """Vectorized Eq. 4–5 core. Each round, every unprotected layer takes its
    preferred feasible halving (macs_per_spe first, else spe — the reference
    candidate order) simultaneously; rounds repeat until no layer can shrink.
    Per-layer decisions are independent (theta_r is fixed at entry), so the
    simultaneous rounds replay each layer's reference shrink sequence exactly.
    """
    theta_r = float(hw.throughput_vec(lv, spe, n).min())
    lo = theta_r * (1 + 1e-9) if strict else theta_r * (1 - 1e-12)
    spe, n = spe.copy(), n.copy()
    free = ~protect
    while True:
        cand_n = np.maximum(1, n >> 1)
        ok_n = free & (cand_n != n) & \
            (hw.throughput_vec(lv, spe, cand_n) >= lo)
        cand_s = np.maximum(1, spe >> 1)
        ok_s = free & ~ok_n & (cand_s != spe) & \
            (hw.throughput_vec(lv, cand_s, n) >= lo)
        if not (ok_n.any() or ok_s.any()):
            return spe, n
        n = np.where(ok_n, cand_n, n)
        spe = np.where(ok_s, cand_s, spe)


def rate_balance(layers: Sequence[LayerCost], designs: List[DesignPoint],
                 hw: HardwareModel, *, protect: Optional[set] = None,
                 strict: bool = False) -> List[DesignPoint]:
    """Eq. 4–5: shrink every non-bottleneck layer to the smallest design whose
    modeled throughput still meets the pipeline's actual rate theta_r.

    ``strict=True`` is used *during* incrementing: a shrink must leave the
    layer's rate strictly above theta_r. With the literal (non-strict) Eq. 4
    rule, growing one of several bottleneck-tied layers gets undone by the
    next balancing pass (rate lands exactly on theta_r and is "still
    feasible"), deadlocking the greedy loop. Strict balancing keeps every
    layer within (theta_r, 2*theta_r] during growth; the final non-strict pass
    reclaims the leftover, which is the paper's Eq. 4 verbatim.
    ``protect`` exempts the just-grown layer.

    Vectorized; equivalent to ``rate_balance_ref`` design-for-design."""
    mask = np.zeros(len(designs), dtype=bool)
    for i in (protect or ()):
        mask[i] = True
    spe, n = _design_arrays(designs)
    spe, n = _balance_arrays(hw, hw.layer_vectors(layers), spe, n, mask,
                             strict)
    return _designs_from(spe, n)


def _run_incremental(lv: LayerVectors, hw: HardwareModel, budget: float,
                     max_iters: int):
    """Array-native §V-A.3 greedy loop; returns (spe, n, thr, res, trace).

    The state is two int vectors plus three maintained rate vectors: each
    layer's current rate (Eq. 2) and its rate after one macs_per_spe / one
    spe halving. Per iteration the engine does O(L) flat scans (argmin,
    shrink-feasibility) and re-derives rates only for the 1–2 layers that
    actually change, with the identical scalar expressions the reference
    evaluates — so results match ``incremental_dse_ref`` bit for bit while
    skipping its O(L * shrink-tries) dataclass churn and throughput
    recomputation.
    """
    L = len(lv)
    macs = lv.macs.tolist()
    m_dot = lv.m_dot.tolist()
    s_eff = lv.s_eff.tolist()
    max_n = lv.max_n.tolist()
    max_spe = lv.max_spe.tolist()
    unit = lv.res_unit.tolist()
    # t_cycles numerator per layer: (1 - s_eff) * m_dot, times the pattern
    # decode-cost multiplier when one is set (DESIGN.md §16). With t_scale
    # None this is the exact sub-expression t_cycles evaluated before, so
    # the default path is bit-identical.
    if lv.t_scale is None:
        om = [(1.0 - s_eff[i]) * m_dot[i] for i in range(L)]
    else:
        tsc = lv.t_scale.tolist()
        om = [(1.0 - s_eff[i]) * m_dot[i] * tsc[i] for i in range(L)]
    spe = [1] * L
    n = [1] * L
    # maintained per-layer rates: current (Eq. 2) and after one halving of
    # each coordinate — flat float lists; O(L) scans at Python-scalar cost
    # beat numpy-reduction dispatch for every realistic pipeline depth
    thr = [0.0] * L
    thr_nh = [0.0] * L
    thr_sh = [0.0] * L

    ceil = math.ceil

    def thr_of(i: int, s: int, nn: int) -> float:
        if not macs[i]:
            return float("inf")
        t = max(1, ceil(om[i] / max(nn, 1)))
        return s * m_dot[i] / (macs[i] * t)

    def sync(i: int) -> None:
        thr[i] = thr_of(i, spe[i], n[i])
        thr_nh[i] = thr_of(i, spe[i], max(1, n[i] // 2))
        thr_sh[i] = thr_of(i, max(1, spe[i] // 2), n[i])

    for i in range(L):
        sync(i)
    # resource totals are exact (integer DSPs / dyadic tile-lane fractions),
    # so incremental updates equal the reference's full re-summation
    res_total = float(sum(unit))

    def balance(lo: float, skip) -> List[Tuple[int, int, int]]:
        """One Eq. 4–5 pass against fixed ``lo``. ``skip`` is a protected
        layer index or per-layer bool list. Returns [(i, old_spe, old_n)] of
        changed layers. A layer shrinks at all iff its first halving is
        feasible, and each shrink chain is n-halvings then spe-halvings (rate
        is monotone in both coordinates, so the reference's retry-n-first
        loop reduces to exactly this), in scalar exact arithmetic."""
        nonlocal res_total
        changed = []
        skip_is_idx = isinstance(skip, int)
        for i in range(L):
            if (skip[i] if not skip_is_idx else i == skip):
                continue
            if not ((n[i] > 1 and thr_nh[i] >= lo) or
                    (spe[i] > 1 and thr_sh[i] >= lo)):
                continue
            s_i, n_i = spe[i], n[i]
            changed.append((i, s_i, n_i))
            while True:
                if n_i > 1 and thr_of(i, s_i, n_i // 2) >= lo:
                    n_i //= 2
                    continue
                if s_i > 1 and thr_of(i, s_i // 2, n_i) >= lo:
                    s_i //= 2
                    continue
                break
            res_total += (s_i * n_i - spe[i] * n[i]) * unit[i]
            spe[i], n[i] = s_i, n_i
            sync(i)
        return changed

    trace: List[Tuple[float, float]] = []
    # design-state snapshot per trace row: any frontier point can later be
    # materialized into concrete DesignPoints without re-running the search
    states: List[Tuple[List[int], List[int]]] = []
    for _ in range(max_iters):
        cur_thr = min(thr)
        slow = thr.index(cur_thr)
        trace.append((res_total, cur_thr))
        states.append((spe.copy(), n.copy()))
        # candidate increments for the slowest layer (macs_per_spe doubling
        # first — the reference option order, which wins Δthr/Δres ties)
        cur_res = spe[slow] * n[slow] * unit[slow]
        best = None
        best_score = None
        if n[slow] < max_n[slow]:
            n2 = min(n[slow] * 2, max_n[slow])
            dres = spe[slow] * n2 * unit[slow] - cur_res
            best = (spe[slow], n2)
            best_score = (thr_of(slow, spe[slow], n2) - cur_thr) / \
                max(dres, 1e-9)
        if spe[slow] < max_spe[slow]:
            s2 = min(spe[slow] * 2, max_spe[slow])
            dres = s2 * n[slow] * unit[slow] - cur_res
            score = (thr_of(slow, s2, n[slow]) - cur_thr) / max(dres, 1e-9)
            if best is None or score > best_score:
                best, best_score = (s2, n[slow]), score
        if best is None:
            break
        # apply the growth, strict-balance everyone else, keep if affordable
        res_before = res_total
        old_slow = (slow, spe[slow], n[slow])
        res_total += (best[0] * best[1] - spe[slow] * n[slow]) * unit[slow]
        spe[slow], n[slow] = best
        sync(slow)
        changed = balance(min(thr) * (1 + 1e-9), skip=slow)
        if res_total > budget:
            for i, s_i, n_i in [old_slow] + changed:
                spe[i], n[i] = s_i, n_i
                sync(i)
            res_total = res_before
            break

    # final literal Eq. 4 pass: trim over-provision, keep the bottleneck set
    theta_r = min(thr)
    hi = theta_r * (1 + 1e-9)
    balance(theta_r * (1 - 1e-12), skip=[r <= hi for r in thr])
    f_thr = min(thr)
    states.append((spe.copy(), n.copy()))
    frontier = _build_frontier([r for r, _ in trace] + [res_total],
                               [t for _, t in trace] + [f_thr], states)
    return (np.array(spe, dtype=np.int64), np.array(n, dtype=np.int64),
            f_thr, res_total, trace, frontier, theta_r)


def _layer_classes(lv: LayerVectors):
    """Partition layers into dynamics classes: two layers behave bit-
    identically inside the greedy iff their (macs, m_dot, s_eff, max_n,
    max_spe, res_unit, t_scale) tuples are equal — the rate function and
    resource accounting read nothing else. Returns (C, pos) with ``pos[c]`` the
    ascending member positions of class ``c`` (first-appearance order).
    One ``tolist`` per column then a flat dict loop — per-element numpy
    indexing is the thing to avoid here, not the Python loop."""
    tsc = [1.0] * len(lv) if lv.t_scale is None else lv.t_scale.tolist()
    cols = zip(lv.macs.tolist(), lv.m_dot.tolist(), lv.s_eff.tolist(),
               lv.max_n.tolist(), lv.max_spe.tolist(), lv.res_unit.tolist(),
               tsc)
    seen: Dict[tuple, int] = {}
    pos: List[List[int]] = []
    for i, key in enumerate(cols):
        c = seen.setdefault(key, len(pos))
        if c == len(pos):
            pos.append([])
        pos[c].append(i)
    return len(pos), pos


def _run_incremental_grouped(lv: LayerVectors, hw: HardwareModel,
                             budget: float, max_iters: int,
                             classes=None):
    """Class-grouped §V-A.3 greedy: bit-identical to ``_run_incremental``
    but O(G) per iteration instead of O(L), where G is the number of live
    (class, design-state) groups — deep LM stacks repeat the same ~10 matmul
    shapes across blocks, so G stays near the class count while L is in the
    hundreds (DESIGN.md §12).

    Exactness argument: the greedy reads a layer only through its class
    constants and design state, ties on the rate argmin break by lowest
    layer position (``thr.index``), and within a class the min-rate group's
    copies share one state so the winner is the group's first position.
    Copies therefore split off a group one position at a time in ascending
    order, keeping every group a contiguous position run; balance shrinks
    map whole groups identically, and ``res_total`` is accumulated over
    changed copies in ascending position order — the flat engine's float
    summation order, term for term."""
    L = len(lv)
    C, pos = classes if classes is not None else _layer_classes(lv)
    macs = [int(lv.macs[pos[c][0]]) for c in range(C)]
    m_dot = [int(lv.m_dot[pos[c][0]]) for c in range(C)]
    s_eff = [float(lv.s_eff[pos[c][0]]) for c in range(C)]
    max_n = [int(lv.max_n[pos[c][0]]) for c in range(C)]
    max_spe = [int(lv.max_spe[pos[c][0]]) for c in range(C)]
    unit = [float(lv.res_unit[pos[c][0]]) for c in range(C)]
    # per-class t_cycles numerator, pattern-scaled exactly like the flat
    # engine (same float op order, so grouped == flat stays bit-exact)
    if lv.t_scale is None:
        om = [(1.0 - s_eff[c]) * m_dot[c] for c in range(C)]
    else:
        om = [(1.0 - s_eff[c]) * m_dot[c] * float(lv.t_scale[pos[c][0]])
              for c in range(C)]

    ceil = math.ceil

    def thr_of(c: int, s: int, nn: int) -> float:
        if not macs[c]:
            return float("inf")
        t = max(1, ceil(om[c] / max(nn, 1)))
        return s * m_dot[c] / (macs[c] * t)

    # groups: per class, ascending-start list of
    # [start, cnt, s, n, rate, rate_nh, rate_sh]; positions of a group are
    # pos[c][start:start+cnt]. rate_nh/rate_sh are the rates after one
    # n-/spe-halving — maintained so balance entry checks are list reads,
    # the flat engine's thr_nh/thr_sh trick at group granularity.
    def _group(c: int, start: int, cnt: int, s: int, nn: int) -> List:
        return [start, cnt, s, nn, thr_of(c, s, nn),
                thr_of(c, s, max(1, nn // 2)), thr_of(c, max(1, s // 2), nn)]

    cgroups: List[List[List]] = [[_group(c, 0, len(pos[c]), 1, 1)]
                                 for c in range(C)]
    # flat per-layer design mirror, kept in sync with the groups; state
    # history is a per-row mutation log (``muts``), so a trace row costs
    # O(changes) instead of O(L) — wave rows change exactly one layer
    spe_l = [1] * L
    n_l = [1] * L
    # exact flat-engine float: sum(res_unit) in ascending position order
    res_total = float(sum(lv.res_unit.tolist()))

    def scan_min():
        """(min rate, argmin class, argmin group, strict second) in one
        pass; rate ties break by lowest member position — exactly the flat
        engine's ``thr.index(min(thr))``. ``second`` is the min over groups
        other than the argmin group (== cur on a tie)."""
        cur = second = math.inf
        best_c = best_g = None
        best_pos = L
        for c in range(C):
            for g in cgroups[c]:
                r = g[4]
                if r < cur:
                    second = cur
                    cur, best_c, best_g = r, c, g
                    best_pos = pos[c][g[0]]
                elif r == cur:
                    second = cur
                    p = pos[c][g[0]]
                    if p < best_pos:
                        best_c, best_g, best_pos = c, g, p
                elif r < second:
                    second = r
        return cur, best_c, best_g, second

    def compact(c: int) -> None:
        gs = cgroups[c]
        out = [gs[0]]
        for g in gs[1:]:
            p = out[-1]
            if p[2] == g[2] and p[3] == g[3]:
                p[1] += g[1]
            else:
                out.append(g)
        cgroups[c] = out

    # lazy per-row undo log: class -> its group list at row start; a budget
    # revert restores exactly the touched classes
    iter_log: Dict[int, List[List]] = {}

    def touch(c: int) -> None:
        if c not in iter_log:
            iter_log[c] = [list(g) for g in cgroups[c]]

    trace: List[Tuple[float, float]] = []
    muts: List[List[Tuple[int, int, int]]] = []   # per trace row: (p, s, n)
    undo: List[Tuple[int, int, int]] = []         # current row (p, s, n) old

    def balance(lo: float, skip) -> None:
        """One Eq. 4–5 pass against fixed ``lo``. ``skip`` is a group object
        or a set of id(group)s. Shrink chains are per-group (all copies of a
        group share the decision); the res_total deltas are then applied in
        ascending copy-position order, replaying the flat engine's float
        accumulation exactly."""
        nonlocal res_total
        updates: List[Tuple[int, float]] = []
        touched = []
        skip_set = skip if isinstance(skip, set) else None
        row = muts[-1]
        for c in range(C):
            for g in cgroups[c]:
                if g is skip or (skip_set and id(g) in skip_set):
                    continue
                s, nn = g[2], g[3]
                if not ((nn > 1 and g[5] >= lo) or (s > 1 and g[6] >= lo)):
                    continue
                touch(c)
                s_i, n_i = s, nn
                while True:
                    if n_i > 1 and thr_of(c, s_i, n_i // 2) >= lo:
                        n_i //= 2
                        continue
                    if s_i > 1 and thr_of(c, s_i // 2, n_i) >= lo:
                        s_i //= 2
                        continue
                    break
                delta = (s_i * n_i - s * nn) * unit[c]
                for p in pos[c][g[0]:g[0] + g[1]]:
                    updates.append((p, delta))
                    undo.append((p, spe_l[p], n_l[p]))
                    row.append((p, s_i, n_i))
                    spe_l[p] = s_i
                    n_l[p] = n_i
                g[2:] = _group(c, g[0], g[1], s_i, n_i)[2:]
                touched.append(c)
        updates.sort()
        for _, d in updates:
            res_total += d
        for c in set(touched):
            compact(c)

    it = 0
    broke = False
    while it < max_iters and not broke:
        cur_thr, slow_c, slow_g, second = scan_min()
        s, nn = slow_g[2], slow_g[3]
        cur_res = s * nn * unit[slow_c]
        best = None
        best_score = None
        if nn < max_n[slow_c]:
            n2 = min(nn * 2, max_n[slow_c])
            dres = s * n2 * unit[slow_c] - cur_res
            best = (s, n2)
            best_score = (thr_of(slow_c, s, n2) - cur_thr) / max(dres, 1e-9)
        if s < max_spe[slow_c]:
            s2 = min(s * 2, max_spe[slow_c])
            dres = s2 * nn * unit[slow_c] - cur_res
            score = (thr_of(slow_c, s2, nn) - cur_thr) / max(dres, 1e-9)
            if best is None or score > best_score:
                best = (s2, nn)
        if best is None:
            trace.append((res_total, cur_thr))
            muts.append([])
            break
        grown_rate = thr_of(slow_c, best[0], best[1])
        dgrow = (best[0] * best[1] - s * nn) * unit[slow_c]
        # wave width: while >1 copies lag at the strict minimum and the
        # grown design strictly improves, every next flat iteration grows
        # the next lagging copy with the identical decision, the pipeline
        # minimum stays cur_thr, and the balance pass is a no-op after the
        # first (same lo, feasibility unchanged) — batch those iterations.
        # The no-op argument needs the grown design itself to be
        # unshrinkable at that lo (a ceil-plateau spe-doubling can leave
        # its n free to halve, which the flat engine's next pass takes)
        wave = 0
        if slow_g[1] > 1 and grown_rate > cur_thr and cur_thr < second:
            lo_wave = cur_thr * (1 + 1e-9)
            g_nh = thr_of(slow_c, best[0], max(1, best[1] // 2))
            g_sh = thr_of(slow_c, max(1, best[0] // 2), best[1])
            if not ((best[1] > 1 and g_nh >= lo_wave) or
                    (best[0] > 1 and g_sh >= lo_wave)):
                # batch up to cnt-2 follow-up copies: growing the LAST
                # lagging copy moves the pipeline minimum, so its balance
                # pass runs at a different lo — leave it to a normal step
                wave = min(slow_g[1] - 2, max_iters - it - 1)
        iter_log.clear()
        undo.clear()
        res_before = res_total
        touch(slow_c)
        trace.append((res_total, cur_thr))
        muts.append([])
        # split the first (lowest-position) copy off the argmin group and
        # grow it — the flat engine grows exactly that layer index
        if slow_g[1] == 1:
            grown = slow_g
        else:
            grown = list(slow_g)
            grown[1] = 1
            slow_g[0] += 1
            slow_g[1] -= 1
            gi = cgroups[slow_c].index(slow_g)
            cgroups[slow_c].insert(gi, grown)
        res_total += dgrow
        grown[2:] = _group(slow_c, grown[0], 1, best[0], best[1])[2:]
        p_grown = pos[slow_c][grown[0]]
        undo.append((p_grown, spe_l[p_grown], n_l[p_grown]))
        muts[-1].append((p_grown, best[0], best[1]))
        spe_l[p_grown], n_l[p_grown] = best
        # min(thr) after the growth, without a rescan: growth only raised
        # the grown copy's rate; the lagging remainder (if any) still sits
        # at cur_thr, everything else at >= second (exact same floats the
        # flat engine's fresh min() sees)
        if grown is slow_g:
            m_after = second if second < grown_rate else grown_rate
        else:
            m_after = cur_thr
        balance(m_after * (1 + 1e-9), skip=grown)
        compact(slow_c)
        it += 1
        if res_total > budget:
            for c, gs in iter_log.items():
                cgroups[c] = gs
            for p, s_o, n_o in reversed(undo):
                spe_l[p], n_l[p] = s_o, n_o
            muts[-1] = []
            res_total = res_before
            break
        if not wave:
            continue
        # batched wave steps (flat iterations 2..wave+1 of this run).
        # compact() may have merged the grown singleton into an adjacent
        # same-state group (a previous interrupted wave's accumulator), so
        # re-locate the LIVE group holding the grown copy before mutating
        start0 = grown[0]
        acc = None
        for g in cgroups[slow_c]:
            if g[0] <= start0 < g[0] + g[1]:
                acc = g
                break
        for _ in range(wave):
            trace.append((res_total, cur_thr))
            muts.append([])
            res_wave = res_total
            p = pos[slow_c][slow_g[0]]
            slow_g[0] += 1
            slow_g[1] -= 1
            acc[1] += 1
            res_total += dgrow
            muts[-1].append((p, best[0], best[1]))
            spe_l[p], n_l[p] = best
            it += 1
            if res_total > budget:
                slow_g[0] -= 1
                slow_g[1] += 1
                acc[1] -= 1
                spe_l[p], n_l[p] = s, nn
                muts[-1] = []
                res_total = res_wave
                broke = True
                break

    theta_r = scan_min()[0]
    hi = theta_r * (1 + 1e-9)
    protected = {id(g) for gs in cgroups for g in gs if g[4] <= hi}
    muts.append([])           # final-pass mutations, applied after row T-1
    undo.clear()
    balance(theta_r * (1 - 1e-12), skip=protected)
    f_thr = scan_min()[0]

    res_pts = [r for r, _ in trace] + [res_total]
    thr_pts = [t for _, t in trace] + [f_thr]
    frontier = _frontier_from_muts(res_pts, thr_pts, muts, L)
    return (np.array(spe_l, dtype=np.int64), np.array(n_l, dtype=np.int64),
            f_thr, res_total, trace, frontier, theta_r)


def _frontier_from_muts(res_pts: List[float], thr_pts: List[float],
                        muts: List[List[Tuple[int, int, int]]],
                        L: int) -> ParetoFrontier:
    """Frontier assembly from a per-row mutation log: replay the log once,
    materializing the kept rows (row j's state = initial + muts[0..j-1]);
    the final point is the post-trim state, one replay step past the last
    row (``muts[-1]`` is the final Eq. 4 pass). Shared by the grouped and
    proposal-batched engines, which keep O(changes) mutation rows instead
    of the flat engine's O(L) per-row snapshots. A row is either a list of
    (p, s, n) mutations or — the batched engine's wave rows, which mutate
    exactly one layer — a bare (p, s, n) tuple."""
    keep = _frontier_keep(res_pts, thr_pts)
    keep_set = set(keep)
    spe_r = np.ones(L, dtype=np.int64)
    n_r = np.ones(L, dtype=np.int64)
    kept: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    last = len(res_pts) - 1
    for j in range(last):               # trace rows: state BEFORE muts[j]
        if j in keep_set:
            kept[j] = (spe_r.copy(), n_r.copy())
        row = muts[j]
        if type(row) is tuple:
            spe_r[row[0]] = row[1]
            n_r[row[0]] = row[2]
        else:
            for p, s_m, n_m in row:
                spe_r[p] = s_m
                n_r[p] = n_m
    row = muts[-1]                      # final Eq. 4 pass
    if type(row) is tuple:
        spe_r[row[0]] = row[1]
        n_r[row[0]] = row[2]
    else:
        for p, s_m, n_m in row:
            spe_r[p] = s_m
            n_r[p] = n_m
    kept[last] = (spe_r, n_r)
    return ParetoFrontier(
        res=np.array([res_pts[i] for i in keep], dtype=np.float64),
        thr=np.array([thr_pts[i] for i in keep], dtype=np.float64),
        spe=np.stack([kept[i][0] for i in keep]),
        n=np.stack([kept[i][1] for i in keep]))


def _run_dse(lv: LayerVectors, hw: HardwareModel, budget: float,
             max_iters: int, engine: str = "auto"):
    """Engine dispatch: ``grouped`` when enough layers share a dynamics
    class to pay for the group bookkeeping, ``flat`` otherwise. Both are
    bit-exact (property-tested), so ``auto`` is a pure perf choice."""
    classes = None
    if engine == "auto":
        classes = _layer_classes(lv)
        engine = "grouped" if len(lv) >= 16 and 2 * classes[0] <= len(lv) \
            else "flat"
    if engine == "grouped":
        ENGINE_DISPATCH.inc("grouped")
        return _run_incremental_grouped(lv, hw, budget, max_iters,
                                        classes=classes)
    if engine != "flat":
        raise ValueError(f"unknown engine {engine!r}")
    ENGINE_DISPATCH.inc("flat")
    return _run_incremental(lv, hw, budget, max_iters)


# --------------------------------------------------------------------- #
# Proposal-batched engine (DESIGN.md §15): one array program advances all
# k proposals of a TPE wave at once, bit-exact per proposal.
# --------------------------------------------------------------------- #
def _run_incremental_batch(lv: LayerVectors, hw: HardwareModel,
                           budget: float, s_eff_batch: np.ndarray,
                           max_iters: int):
    """Proposal-batched §V-A.3 greedy: B independent flat-engine runs over
    one shared workload template, advanced in lockstep on (B, L) arrays —
    per round, every still-active proposal takes its next real growth step
    in one array program (argmin, option scoring, strict balance), and
    proposals whose run has converged (no growth option / budget break /
    max_iters) are masked out. Wave runs — the grouped engine's batching of
    identical lagging-copy growths — collapse per proposal into O(wave)
    Python bookkeeping between rounds, so a kind-tied LM stack costs
    ~#distinct-growth-decisions rounds, not ~max_iters (DESIGN.md §15).

    Bit-exactness per proposal vs ``_run_incremental`` rests on three
    facts. (1) Proposals never interact: every array op is elementwise per
    proposal row, with float semantics identical to the flat engine's
    scalar expressions (same operation order; products < 2**53, the
    ``throughput_vec`` invariant). (2) ``res_total`` float accumulation
    replays the flat engine's ascending-layer order: balance deltas are
    applied column-by-column in ascending layer order and adding the 0.0
    of an untouched (proposal, layer) cell is an exact identity. (3) Wave
    runs generalize the grouped engine's argument to the whole tied set:
    the flat engine's next argmins are exactly the ascending tied
    positions, each growth applies that copy's own class decision, and
    while every grown copy strictly improves and is unshrinkable at
    ``lo = cur*(1+1e-9)`` the interleaved balance passes are no-ops — so
    the prefix of the tied set satisfying the per-copy conditions (minus a
    last copy, whose growth moves the pipeline minimum) advances in one
    bookkeeping sweep instead of one round each (DESIGN.md §15).

    Returns a list of B (spe, n, f_thr, res, trace, frontier, theta_r)
    tuples, each bit-identical to the serial engines' output.
    """
    S = np.ascontiguousarray(s_eff_batch, dtype=np.float64)
    B, L = S.shape
    macs = lv.macs
    m_dot = lv.m_dot
    max_n = lv.max_n
    max_spe = lv.max_spe
    unit = lv.res_unit
    nz = macs > 0
    has_zero = not bool(nz.all())
    # (1 - s_eff) * m_dot, the t_cycles numerator — scalar op order kept;
    # pattern decode costs multiply afterwards exactly like the serial
    # engines' per-layer ``* t_scale`` (DESIGN.md §16)
    omsm = (1.0 - S) * m_dot
    if lv.t_scale is not None:
        omsm = omsm * lv.t_scale

    # design-state n is always >= 1 (floors at 1, candidates are clipped),
    # so the scalar engine's max(nn, 1) divisor guard is an identity here
    def rates_pre(om, md, mc, nzm, s_a, n_a):
        """Eq. 1-2 on pre-gathered constants — float-for-float the flat
        engine's ``thr_of`` (``throughput_vec`` invariant)."""
        t = np.maximum(1.0, np.ceil(om / n_a))
        r = (s_a * md) / (mc * t)
        return np.where(nzm, r, np.inf) if has_zero else r

    def rates(spe_a, n_a):
        """Eq. 1-2 on full (B, L) state arrays."""
        return rates_pre(omsm, m_dot, macs, nz, spe_a, n_a)

    spe = np.ones((B, L), dtype=np.int64)
    n = np.ones((B, L), dtype=np.int64)
    # exact flat-engine float: sum(res_unit) in ascending position order
    res0 = 0.0
    for u in unit.tolist():
        res0 += u
    res = np.full(B, res0, dtype=np.float64)
    it = np.zeros(B, dtype=np.int64)
    active = np.ones(B, dtype=bool)
    trace: List[List[Tuple[float, float]]] = [[] for _ in range(B)]
    muts: List[list] = [[] for _ in range(B)]
    ar = np.arange(B)

    # maintained rate views of the design state — thr == rates(spe, n) and
    # r_nh/r_sh are the one-halving rates (the flat engine's thr_nh/thr_sh
    # trick at (B, L)); refreshed at exactly the cells whose (spe, n)
    # changed, so steady-state rounds do O(changed) rate math, not O(B*L)
    thr = rates(spe, n)
    r_nh = thr.copy()               # n == 1: halving is the identity
    r_sh = thr.copy()               # spe == 1

    def refresh(bi, li):
        """Recompute the maintained rates at the given gathered cells."""
        s_g = spe[bi, li]
        n_g = n[bi, li]
        om = omsm[bi, li]
        md = m_dot[li]
        mc = macs[li]
        nzm = nz[li]
        thr[bi, li] = rates_pre(om, md, mc, nzm, s_g, n_g)
        r_nh[bi, li] = rates_pre(om, md, mc, nzm, s_g,
                                 np.maximum(1, n_g >> 1))
        r_sh[bi, li] = rates_pre(om, md, mc, nzm,
                                 np.maximum(1, s_g >> 1), n_g)

    def balance(lo, mask, skip_rows=None, skip_cols=None, protect=None):
        """One vectorized Eq. 4-5 pass at per-proposal fixed ``lo`` over
        the proposals in ``mask``. ``skip_rows``/``skip_cols`` protect one
        (proposal, layer) cell each (the just-grown layer); ``protect`` is
        a (B, L) bool mask (the final pass's bottleneck set). Entry reads
        the maintained halving rates; the shrink chains then run on the
        gathered entered cells only, each cell taking the flat engine's
        preferred feasible halving (n first) per step. Mutation rows are
        appended and res deltas accumulated per proposal in ascending
        layer order — the flat engine's float summation, term for term.
        Returns the changed cells' (bi, li, prev_spe, prev_n) so a budget
        revert can restore and re-``refresh`` exactly those cells."""
        lo2 = lo[:, None]
        ent = mask[:, None] & (((n > 1) & (r_nh >= lo2)) |
                               ((spe > 1) & (r_sh >= lo2)))
        if protect is not None:
            ent &= ~protect
        if skip_rows is not None:
            ent[skip_rows, skip_cols] = False
        if not ent.any():
            return None
        bi, li = np.nonzero(ent)        # row-major: ascending li per row
        s_g = spe[bi, li]
        n_g = n[bi, li]
        ps = s_g.copy()
        pn = n_g.copy()
        om = omsm[bi, li]
        md = m_dot[li]
        mc = macs[li]
        nzm = nz[li]
        lo_g = lo[bi]
        while True:
            cn = np.maximum(1, n_g >> 1)
            ok_n = (cn != n_g) & \
                (rates_pre(om, md, mc, nzm, s_g, cn) >= lo_g)
            cs = np.maximum(1, s_g >> 1)
            ok_s = ~ok_n & (cs != s_g) & \
                (rates_pre(om, md, mc, nzm, cs, n_g) >= lo_g)
            if not (ok_n.any() or ok_s.any()):
                break
            n_g[ok_n] = cn[ok_n]
            s_g[ok_s] = cs[ok_s]
        spe[bi, li] = s_g
        n[bi, li] = n_g
        refresh(bi, li)
        delta = ((s_g * n_g - ps * pn) * unit[li]).tolist()
        li_l = li.tolist()
        s_l = s_g.tolist()
        n_l = n_g.tolist()
        starts = np.searchsorted(bi, ar)
        ends = np.searchsorted(bi, ar, side="right")
        for b in np.unique(bi).tolist():
            r = float(res[b])
            row = muts[b][-1]
            for j in range(int(starts[b]), int(ends[b])):
                r += delta[j]
                row.append((li_l[j], s_l[j], n_l[j]))
            res[b] = r
        return bi, li, ps, pn

    while active.any():
        cur = thr.min(axis=1)
        slow = thr.argmin(axis=1)       # first minimum — thr.index(min)
        sl_s = spe[ar, slow]
        sl_n = n[ar, slow]
        sl_unit = unit[slow]
        sl_maxn = max_n[slow]
        sl_maxs = max_spe[slow]
        om_s = omsm[ar, slow]
        md_s = m_dot[slow]
        mc_s = macs[slow]
        nz_s = nz[slow]
        cur_res = sl_s * sl_n * sl_unit
        # candidate increments (macs_per_spe doubling first — wins ties)
        have_n = sl_n < sl_maxn
        n2 = np.minimum(sl_n * 2, sl_maxn)
        dres_n = sl_s * n2 * sl_unit - cur_res
        score_n = (rates_pre(om_s, md_s, mc_s, nz_s, sl_s, n2) - cur) / \
            np.maximum(dres_n, 1e-9)
        have_s = sl_s < sl_maxs
        s2 = np.minimum(sl_s * 2, sl_maxs)
        dres_s = s2 * sl_n * sl_unit - cur_res
        score_s = (rates_pre(om_s, md_s, mc_s, nz_s, s2, sl_n) - cur) / \
            np.maximum(dres_s, 1e-9)
        use_s = have_s & (~have_n | (score_s > score_n))
        b_s = np.where(use_s, s2, sl_s)
        b_n = np.where(use_s, sl_n, n2)
        none = ~(have_n | have_s)
        grown_rate = rates_pre(om_s, md_s, mc_s, nz_s, b_s, b_n)
        dgrow = (b_s * b_n - sl_s * sl_n) * sl_unit
        grow = active & ~none
        # wave pre-check (round-start state, before any mutation): the flat
        # engine's next argmins are exactly the ascending positions tied at
        # ``cur``, so compute each tied copy's own growth decision and take
        # the prefix whose grown designs all strictly improve and are
        # unshrinkable at lo = cur*(1+1e-9) — those flat iterations have
        # no-op balance passes and collapse into bookkeeping (DESIGN.md §15)
        wave: Dict[int, Tuple[np.ndarray, ...]] = {}
        tied_m = grow[:, None] & (thr == cur[:, None])
        t_cnt = tied_m.sum(axis=1)
        rows_w = (t_cnt >= 2) & (it < max_iters - 1)
        if rows_w.any():
            tied_m &= rows_w[:, None]
            bi, li = np.nonzero(tied_m)   # row-major: ascending positions
            t_s = spe[bi, li]
            t_n = n[bi, li]
            t_u = unit[li]
            t_mn = max_n[li]
            t_ms = max_spe[li]
            t_cur = cur[bi]
            om_t = omsm[bi, li]
            md_t = m_dot[li]
            mc_t = macs[li]
            nz_t = nz[li]
            t_res = t_s * t_n * t_u
            t_hn = t_n < t_mn
            t_n2 = np.minimum(t_n * 2, t_mn)
            t_scn = (rates_pre(om_t, md_t, mc_t, nz_t, t_s, t_n2) -
                     t_cur) / np.maximum(t_s * t_n2 * t_u - t_res, 1e-9)
            t_hs = t_s < t_ms
            t_s2 = np.minimum(t_s * 2, t_ms)
            t_scs = (rates_pre(om_t, md_t, mc_t, nz_t, t_s2, t_n) -
                     t_cur) / np.maximum(t_s2 * t_n * t_u - t_res, 1e-9)
            t_us = t_hs & (~t_hn | (t_scs > t_scn))
            w_s = np.where(t_us, t_s2, t_s)
            w_n = np.where(t_us, t_n, t_n2)
            w_gr = rates_pre(om_t, md_t, mc_t, nz_t, w_s, w_n)
            w_dg = (w_s * w_n - t_s * t_n) * t_u
            w_lo = t_cur * (1 + 1e-9)
            w_nh = rates_pre(om_t, md_t, mc_t, nz_t, w_s,
                             np.maximum(1, w_n >> 1))
            w_sh = rates_pre(om_t, md_t, mc_t, nz_t,
                             np.maximum(1, w_s >> 1), w_n)
            w_shr = ((w_n > 1) & (w_nh >= w_lo)) | \
                    ((w_s > 1) & (w_sh >= w_lo))
            ok = (t_hn | t_hs) & (w_gr > t_cur) & ~w_shr
            starts = np.searchsorted(bi, ar)
            ends = np.searchsorted(bi, ar, side="right")
            for b in np.nonzero(rows_w)[0].tolist():
                lo_i, hi_i = int(starts[b]), int(ends[b])
                okb = ok[lo_i:hi_i]
                m = hi_i - lo_i
                k = int(np.argmin(okb)) if not okb.all() else m
                # leave the last tied copy for a real round (its growth
                # moves the pipeline minimum, so its balance lo differs)
                w = min(min(k, m - 1) - 1, int(max_iters - it[b] - 1))
                if w > 0:
                    sl = slice(lo_i + 1, lo_i + 1 + w)
                    wave[b] = (li[sl], w_s[sl], w_n[sl], w_dg[sl],
                               w_gr[sl], w_nh[sl], w_sh[sl])
        # record the round's trace rows; option-less proposals stop here
        res_l = res.tolist()
        cur_l = cur.tolist()
        for b in np.nonzero(active)[0].tolist():
            trace[b].append((res_l[b], cur_l[b]))
            muts[b].append([])
        active &= ~none
        if not grow.any():
            break
        old_res = res.copy()
        # apply the growth, strict-balance everyone else, keep if affordable
        res[grow] += dgrow[grow]
        bi_g = ar[grow]
        li_g = slow[grow]
        spe[bi_g, li_g] = b_s[grow]
        n[bi_g, li_g] = b_n[grow]
        refresh(bi_g, li_g)
        slow_l = slow.tolist()
        bs_l = b_s.tolist()
        bn_l = b_n.tolist()
        for b in np.nonzero(grow)[0].tolist():
            muts[b][-1].append((slow_l[b], bs_l[b], bn_l[b]))
        m_after = thr.min(axis=1)       # fresh min, the flat engine's floats
        bal = balance(m_after * (1 + 1e-9), grow, skip_rows=bi_g,
                      skip_cols=li_g)
        it[grow] += 1
        over = grow & (res > budget)
        if over.any():
            ob = np.nonzero(over)[0]
            spe[ob, slow[ob]] = sl_s[ob]
            n[ob, slow[ob]] = sl_n[ob]
            refresh(ob, slow[ob])
            if bal is not None:
                bbi, bli, bps, bpn = bal
                bm = over[bbi]
                if bm.any():
                    spe[bbi[bm], bli[bm]] = bps[bm]
                    n[bbi[bm], bli[bm]] = bpn[bm]
                    refresh(bbi[bm], bli[bm])
            res[over] = old_res[over]
            for b in ob.tolist():
                muts[b][-1] = []
            active &= ~over
        # batched wave steps (flat iterations 2..wave+1 of each run):
        # np.cumsum is strictly sequential addition, so it replays the flat
        # engine's per-copy ``res += dgrow`` float chain term for term
        for b in np.nonzero(grow & ~over)[0].tolist():
            got = wave.get(b)
            if got is None:
                continue
            wpos, ws, wn, wdg, wgr, wnh, wsh = got
            c_b = cur_l[b]
            r_seq = np.cumsum(np.concatenate(([res[b]], wdg)))
            w = len(wpos)
            over_j = np.nonzero(r_seq[1:] > budget)[0]
            steps = w if over_j.size == 0 else int(over_j[0]) + 1
            done = steps if over_j.size == 0 else steps - 1
            trace[b].extend(zip(r_seq[:steps].tolist(), repeat(c_b, steps)))
            muts[b].extend(zip(wpos[:done].tolist(), ws[:done].tolist(),
                               wn[:done].tolist()))
            if over_j.size:
                muts[b].append([])
                active[b] = False
            res[b] = r_seq[done]
            cp = wpos[:done]
            spe[b, cp] = ws[:done]
            n[b, cp] = wn[:done]
            thr[b, cp] = wgr[:done]
            r_nh[b, cp] = wnh[:done]
            r_sh[b, cp] = wsh[:done]
            it[b] += steps
        active &= it < max_iters

    # final literal Eq. 4 pass: trim over-provision, keep the bottleneck set
    theta = thr.min(axis=1)
    protect = thr <= (theta * (1 + 1e-9))[:, None]
    for b in range(B):
        muts[b].append([])
    balance(theta * (1 - 1e-12), np.ones(B, dtype=bool), protect=protect)
    f_thr = thr.min(axis=1)

    out = []
    for b in range(B):
        res_pts = [r for r, _ in trace[b]] + [float(res[b])]
        thr_pts = [t for _, t in trace[b]] + [float(f_thr[b])]
        frontier = _frontier_from_muts(res_pts, thr_pts, muts[b], L)
        out.append((spe[b].copy(), n[b].copy(), float(f_thr[b]),
                    float(res[b]), trace[b], frontier, float(theta[b])))
    return out


def _run_incremental_batch_c(lv: LayerVectors, hw: HardwareModel,
                             budget: float, s_eff_batch: np.ndarray,
                             max_iters: int, lib):
    """Compiled-backend batched greedy: B independent flat-engine runs in
    one C call (``_dse_ckernel``), plus numpy/C post-processing that
    rebuilds each proposal's trace, frontier and final state. Bit-exact vs
    ``_run_incremental`` by construction — the kernel is a scalar-for-
    scalar port (see the float contract in ``_dse_ckernel``) and the
    frontier path reuses ``_frontier_keep`` on the kernel's own (res, thr)
    points with design snapshots replayed from the kernel's mutation log
    (``dse_replay``), the grouped engine's ``_frontier_from_muts`` scheme
    with the replay loop in C."""
    S = np.ascontiguousarray(s_eff_batch, dtype=np.float64)
    B, L = S.shape
    omsm = np.ascontiguousarray((1.0 - S) * lv.m_dot)
    m_dot = np.ascontiguousarray(lv.m_dot, dtype=np.float64)
    macs = np.ascontiguousarray(lv.macs, dtype=np.float64)
    unit = np.ascontiguousarray(lv.res_unit, dtype=np.float64)
    max_n = np.ascontiguousarray(lv.max_n, dtype=np.int64)
    max_spe = np.ascontiguousarray(lv.max_spe, dtype=np.int64)
    # mutation-stream bound: every growth row logs 1 mut and <= its own
    # halvings; total halvings <= total doublings <= max_iters, and the
    # final trim adds <= L — so 2*max_iters + L covers it (slack for the
    # clipped-growth edge)
    M = 2 * max_iters + L + 16
    spe = np.empty((B, L), dtype=np.int64)
    n = np.empty((B, L), dtype=np.int64)
    res = np.empty(B, dtype=np.float64)
    fthr = np.empty(B, dtype=np.float64)
    theta = np.empty(B, dtype=np.float64)
    tr_res = np.empty((B, max_iters), dtype=np.float64)
    tr_cur = np.empty((B, max_iters), dtype=np.float64)
    tr_len = np.empty(B, dtype=np.int64)
    mut_pos = np.empty((B, M), dtype=np.int64)
    mut_s = np.empty((B, M), dtype=np.int64)
    mut_n = np.empty((B, M), dtype=np.int64)
    mut_cnt = np.zeros((B, max_iters + 1), dtype=np.int64)
    # pointer args are raw addresses (see _dse_ckernel's argtype note):
    # every array above is freshly allocated here, correct dtype, C order
    p = (lambda a: a.ctypes.data)
    rc = lib.dse_run_batch(
        B, L, max_iters, float(budget), p(omsm), p(S), p(m_dot), p(macs),
        p(unit), p(max_n), p(max_spe), p(spe), p(n), p(res), p(fthr),
        p(theta), p(tr_res), p(tr_cur), p(tr_len), p(mut_pos), p(mut_s),
        p(mut_n), p(mut_cnt), M)
    if rc:
        raise RuntimeError("DSE kernel internal error "
                           f"(code {rc}: mutation overflow or OOM)")
    w_spe = np.empty(L, dtype=np.int64)
    w_n = np.empty(L, dtype=np.int64)
    out = []
    for b in range(B):
        T = int(tr_len[b])
        trace = list(zip(tr_res[b, :T].tolist(), tr_cur[b, :T].tolist()))
        res_pts = np.append(tr_res[b, :T], res[b])
        thr_pts = np.append(tr_cur[b, :T], fthr[b])
        keep = np.asarray(_frontier_keep(res_pts, thr_pts), dtype=np.int64)
        K = len(keep)
        order = np.argsort(keep, kind="stable")
        f_spe = np.empty((K, L), dtype=np.int64)
        f_n = np.empty((K, L), dtype=np.int64)
        krows = np.ascontiguousarray(keep[order])   # named: p() takes the
        mp, ms, mn, mc = (mut_pos[b], mut_s[b], mut_n[b], mut_cnt[b])
        lib.dse_replay(L, T + 1, p(mp), p(ms), p(mn), p(mc), K, p(krows),
                       p(f_spe), p(f_n), p(w_spe), p(w_n))   # address only
        inv = np.empty(K, dtype=np.int64)
        inv[order] = np.arange(K)
        frontier = ParetoFrontier(res=res_pts[keep], thr=thr_pts[keep],
                                  spe=f_spe[inv], n=f_n[inv])
        out.append((spe[b], n[b], float(fthr[b]), float(res[b]),
                    trace, frontier, float(theta[b])))
    return out


def _run_batch_dispatch(lv: LayerVectors, hw: HardwareModel, budget: float,
                        s_eff_batch: np.ndarray, max_iters: int,
                        engine: str = "auto"):
    """Batched-engine dispatch: ``compiled`` is the C kernel (DESIGN.md
    §15), ``lockstep`` the pure-numpy array program; ``auto`` prefers the
    kernel and falls back when the environment can't build it. Both are
    bit-exact vs the serial engines (property-tested), so ``auto`` is a
    pure perf choice — like ``_run_dse``'s."""
    if lv.t_scale is not None and engine in ("auto", "compiled"):
        # explicit lockstep-only fallback for patterned rows (DESIGN.md
        # §16): the C kernel's dynamics-class key compares the six
        # pre-pattern per-layer constants and doesn't know t_scale, so two
        # layers with equal s_eff but different decode costs would be
        # mis-grouped there. The numpy lockstep engine consumes the
        # already-scaled omsm and stays bit-exact vs the serial engines.
        if engine == "compiled":
            raise RuntimeError("compiled batch engine does not support "
                               "pattern t_scale rows; use lockstep/auto")
        engine = "lockstep"
    if engine == "auto":
        engine = "compiled" if _dse_ckernel.get_lib() is not None \
            else "lockstep"
    if engine == "compiled":
        lib = _dse_ckernel.get_lib()
        if lib is None:
            raise RuntimeError("compiled DSE kernel unavailable "
                               "(no C compiler or REPRO_DSE_CKERNEL=0)")
        ENGINE_DISPATCH.inc("compiled")
        return _run_incremental_batch_c(lv, hw, budget, s_eff_batch,
                                        max_iters, lib)
    if engine != "lockstep":
        raise ValueError(f"unknown batch engine {engine!r}")
    ENGINE_DISPATCH.inc("lockstep")
    return _run_incremental_batch(lv, hw, budget,
                                  np.asarray(s_eff_batch, dtype=np.float64),
                                  max_iters)


def incremental_dse_batch(lv: LayerVectors, hw: HardwareModel,
                          budget: float, s_eff_batch: np.ndarray,
                          *, max_iters: int = 10000,
                          materialize_designs: bool = True,
                          engine: str = "auto") -> List[DSEResult]:
    """Batched ``incremental_dse`` over one workload template: row ``b`` of
    ``s_eff_batch`` (shape (B, L)) is one proposal's effective-sparsity
    vector; all other workload constants come from ``lv``. Returns B
    ``DSEResult``s, each bit-identical — designs, throughput, resource,
    trace, frontier, theta_r — to ``incremental_dse`` on the corresponding
    single stack (property-tested), at a fraction of B serial runs'
    wall-clock on kind-tied stacks (DESIGN.md §15). ``engine`` selects the
    backend (``compiled``/``lockstep``/``auto``). This is the engine under
    ``DSECache.dse_vec_batch`` / ``hass_search(batch_size=k)``."""
    rows = _run_batch_dispatch(lv, hw, budget,
                               np.asarray(s_eff_batch, dtype=np.float64),
                               max_iters, engine)
    out = []
    for spe, n, f_thr, res, trace, frontier, theta_r in rows:
        designs = _designs_from(spe, n) if materialize_designs else []
        out.append(DSEResult(designs=designs, throughput=f_thr, resource=res,
                             throughput_per_res=f_thr / max(res, 1e-9),
                             trace=trace, frontier=frontier,
                             theta_r=theta_r))
    return out


@dataclass
class DegradationRung:
    """One step of a graceful-degradation ladder: serve at extra sparsity
    ``s_extra`` on top of the searched masks, trading accuracy for the
    throughput of the correspondingly re-searched accelerator. ``step_scale``
    is the decode step-cycle multiplier relative to rung 0 (``thr_base /
    thr_rung``, so faster rungs have smaller scales) — the value
    ``serve.fleet.DegradationPolicy`` consumes."""
    s_extra: float       # extra sparsity fraction composed onto s_eff
    throughput: float    # DSE pipeline throughput at this rung (samples/cyc)
    step_scale: float    # step-cycle multiplier vs rung 0 (<= 1.0)


def degradation_ladder(layers: Sequence[LayerCost], hw: HardwareModel,
                       budget: float,
                       *, s_extra: Sequence[float] = (0.0, 0.15, 0.3),
                       max_iters: int = 10000,
                       engine: str = "auto") -> List[DegradationRung]:
    """Price a graceful-degradation ladder off the sparsity frontier.

    Rung ``k`` composes ``s_extra[k]`` of additional sparsity onto every
    layer's hardware-effective density — ``s' = 1 - (1 - s_eff) * (1 -
    e)`` — and re-runs the batched DSE on the stepped-up stacks in ONE
    ``incremental_dse_batch`` call (rows share the workload template, so
    the lockstep engines amortize the sweep). The returned rungs map each
    accuracy step-down to its measured throughput gain as a step-cycle
    multiplier; feed ``tuple(r.step_scale for r in rungs)`` to
    ``DegradationPolicy(ladder=...)``. ``s_extra`` must start at 0.0
    (rung 0 is the undegraded operating point; its scale is exactly 1.0)
    and increase strictly; scales are clamped monotone nonincreasing so a
    non-monotone greedy-DSE wobble can never produce a ladder the policy
    validator rejects."""
    grid = [float(e) for e in s_extra]
    if not grid or grid[0] != 0.0:
        raise ValueError("degradation_ladder: s_extra must start at 0.0")
    if any(b <= a for a, b in zip(grid, grid[1:])):
        raise ValueError("degradation_ladder: s_extra must increase strictly")
    if any(e < 0.0 or e >= 1.0 for e in grid):
        raise ValueError("degradation_ladder: s_extra must lie in [0, 1)")
    lv = hw.layer_vectors(layers)
    batch = np.stack([1.0 - (1.0 - lv.s_eff) * (1.0 - e) for e in grid])
    results = incremental_dse_batch(lv, hw, budget, batch,
                                    max_iters=max_iters,
                                    materialize_designs=False, engine=engine)
    thr0 = results[0].throughput
    rungs: List[DegradationRung] = []
    floor = 1.0
    for e, r in zip(grid, results):
        scale = 1.0 if e == 0.0 else (
            thr0 / r.throughput if r.throughput > 0.0 else 1.0)
        floor = min(floor, scale)
        rungs.append(DegradationRung(s_extra=e, throughput=r.throughput,
                                     step_scale=floor))
    return rungs


def incremental_dse(layers: Sequence[LayerCost], hw: HardwareModel,
                    budget: float, *, max_iters: int = 10000,
                    engine: str = "auto") -> DSEResult:
    """§V-A.3: start resource-minimal, grow the slowest layer, re-balance.

    Vectorized greedy loop — identical designs/throughput/resource/trace to
    ``incremental_dse_ref`` (property-tested), ~10–100x faster. The returned
    ``DSEResult.frontier`` holds the full non-dominated (resource,
    throughput) set of the search path with per-point design state, so
    consumers (Eq. 6 scoring, DP partitioning) trade points without
    re-running the search (``incremental_dse_ref`` leaves it None).

    ``engine`` picks the loop implementation: ``"flat"`` is the per-layer
    engine; ``"grouped"`` collapses layers with identical dynamics into
    class groups (bit-exact, much faster on deep LM stacks whose blocks
    repeat the same matmul shapes); ``"auto"`` chooses by class count."""
    lv = hw.layer_vectors(layers)
    spe, n, thr, res, trace, frontier, theta_r = _run_dse(lv, hw, budget,
                                                          max_iters, engine)
    return DSEResult(designs=_designs_from(spe, n), throughput=thr,
                     resource=res, throughput_per_res=thr / max(res, 1e-9),
                     trace=trace, frontier=frontier, theta_r=theta_r)


def incremental_dse_ref(layers: Sequence[LayerCost], hw: HardwareModel,
                        budget: float, *, max_iters: int = 10000) -> DSEResult:
    """Reference scalar implementation of ``incremental_dse`` (pre-vectorized
    code, kept verbatim as the equivalence oracle and for ``dse_bench``)."""
    designs = [DesignPoint(1, 1) for _ in layers]
    trace: List[Tuple[float, float]] = []

    def total_res(ds):
        return sum(hw.layer_resource(l, d) for l, d in zip(layers, ds))

    for _ in range(max_iters):
        thr = pipeline_throughput(layers, designs, hw)
        res = total_res(designs)
        trace.append((res, thr))
        # slowest layer
        rates = [hw.layer_throughput(l, d) for l, d in zip(layers, designs)]
        slow = int(np.argmin(rates))
        opts = _grow_options(layers[slow], designs[slow], hw)
        if not opts:
            break
        # pick the increment with best Δthroughput per Δresource
        def score(opt):
            dthr = hw.layer_throughput(layers[slow], opt) - rates[slow]
            dres = hw.layer_resource(layers[slow], opt) - \
                hw.layer_resource(layers[slow], designs[slow])
            return dthr / max(dres, 1e-9)
        opt = max(opts, key=score)
        cand = list(designs)
        cand[slow] = opt
        cand = rate_balance_ref(layers, cand, hw, protect={slow}, strict=True)
        if total_res(cand) > budget:
            break
        designs = cand

    # final literal Eq. 4 pass: trim over-provision, keep the bottleneck set
    rates = [hw.layer_throughput(l, d) for l, d in zip(layers, designs)]
    bottleneck = {i for i, r in enumerate(rates) if r <= min(rates) * (1 + 1e-9)}
    designs = rate_balance_ref(layers, designs, hw, protect=bottleneck)
    thr = pipeline_throughput(layers, designs, hw)
    res = total_res(designs)
    return DSEResult(designs=designs, throughput=thr, resource=res,
                     throughput_per_res=thr / max(res, 1e-9), trace=trace)


# --------------------------------------------------------------------- #
# DSECache: memoized warm-start reuse across DSE calls (DESIGN.md §12, §15)
# --------------------------------------------------------------------- #
def _reachable_n(max_n: int) -> Tuple[int, ...]:
    """Closure of {1} under the two N moves either engine ever makes —
    grow ``n -> min(2n, max_n)`` and shrink ``n -> max(1, n >> 1)``. Every
    N value a layer can hold at any point of any run is in this set
    (O(log^2 max_n) values), which is what makes the level-2 certificate's
    t-vector finite (DESIGN.md §15)."""
    seen = {1}
    stack = [1]
    while stack:
        v = stack.pop()
        for w in (min(2 * v, max_n), max(1, v >> 1)):
            if w not in seen:
                seen.add(w)
                stack.append(w)
    return tuple(sorted(seen))


_REACHABLE_N_MEMO: Dict[int, Tuple[int, ...]] = {}


class DSECache:
    """Exact result reuse for ``incremental_dse`` across a search session.

    Three reuse levels, all bit-exact (property-tested in
    ``tests/test_dse_cache.py``):

      * **exact** — results are memoized on the full dynamics key: the
        ``s_eff`` float vector plus a fingerprint of the workload constants
        (macs, m_dot, caps, res_unit), budget and max_iters. Equal keys
        replay the identical greedy trajectory by determinism.
      * **warm level 1** — the floor-stability theorem: a layer whose
        design the greedy never grows stays at the resource floor (1, 1)
        for the whole run (shrinking from the floor is impossible), and it
        is never grown iff its floor rate strictly exceeds ``theta_r``, the
        run's peak bottleneck rate. Such a layer contributes a constant to
        every decision the greedy takes — argmin selection, balance
        feasibility, budget accounting — so two stacks that differ ONLY in
        layers that are floor-stable on both sides (rate at (1,1) strictly
        above the cached run's theta_r under both the cached and the query
        sparsity) have bit-identical DSE results.
      * **warm level 2** — the dynamics-equivalence certificate for
        floor-adjacent layers (layers the anchor run DID grow, where level
        1 can't apply): sparsity reaches the engines only through the
        cycle count ``t(n) = max(1, ceil((1 - s_eff) * m_dot / n))``, and
        ``n`` only ever takes values in the layer's reachable-N closure
        (``_reachable_n``). If a differing layer's float t-vector over
        that whole closure is equal under the cached and the query
        sparsity, every rate the engine can ever compute for it is equal
        float-for-float, so the full decision log replays identically —
        the anchor's growth events for that layer are re-validated against
        the query sparsity in one vector compare (DESIGN.md §15 has the
        proof sketch). When neither certificate can be proven the query
        falls back to a cold run.

    A cold run is the normal engine (grouped/flat dispatch), so a cache
    MISS costs one array compare (plus at most ``_L2_CANDIDATES`` t-vector
    compares) more than no cache at all. Results handed out are shared
    objects — treat them as immutable.
    """

    #: miss-path bound: level-2 certificates are attempted on at most this
    #: many anchors (the ones with the fewest unproven layers), keeping the
    #: worst-case miss overhead flat as anchors accumulate
    _L2_CANDIDATES = 8

    def __init__(self, max_entries: int = 256,
                 materialize_designs: bool = True):
        """``materialize_designs=False`` leaves ``DSEResult.designs`` empty
        on cache-produced results (consumers that only read the frontier —
        the analytic evaluators — skip building L DesignPoint objects per
        cold run; ``ParetoFrontier.materialize`` still rebuilds any point)."""
        self.max_entries = max_entries
        self.materialize_designs = materialize_designs
        # decision counters re-backed by the obs Counters bag (DESIGN.md
        # §18); ``hits``/``warm_l1``/``warm_l2``/``cold_runs`` stay plain
        # read/write attributes via the properties below, so every
        # ``self.hits += 1`` site and the ``stats()`` dict are unchanged
        self._counters = Counters("hits", "warm_l1", "warm_l2", "cold_runs")
        # fingerprint -> {s_eff bytes -> DSEResult}
        self._exact: Dict[int, Dict[bytes, DSEResult]] = {}
        # fingerprint -> [s_eff rows], [rate11 rows], [theta_r], [t-vecs],
        #                [result]
        self._anchors: Dict[int, list] = {}
        # fingerprint -> (flat reachable-N, per-layer segment starts)
        self._nlayout: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _counter(name: str):                       # noqa: N805
        def _get(self) -> int:
            return self._counters.get(name)

        def _set(self, v: int) -> None:
            self._counters.set(name, int(v))

        return property(_get, _set)

    hits = _counter("hits")
    warm_l1 = _counter("warm_l1")
    warm_l2 = _counter("warm_l2")
    cold_runs = _counter("cold_runs")
    del _counter

    @property
    def warm_hits(self) -> int:
        """Back-compat aggregate: warm reuses at either certificate level."""
        return self.warm_l1 + self.warm_l2

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "warm_hits": self.warm_hits,
                "warm_l1": self.warm_l1, "warm_l2": self.warm_l2,
                "cold_runs": self.cold_runs}

    @staticmethod
    def _fingerprint(lv: LayerVectors, budget: float, max_iters: int) -> int:
        # t_scale joins the workload constants (a pattern changes the
        # dynamics, so anchors must never mix across decode-cost vectors);
        # None keeps a distinct sentinel so the default path's keyspace is
        # untouched within a session
        return hash((lv.macs.tobytes(), lv.m_dot.tobytes(),
                     lv.max_n.tobytes(), lv.max_spe.tobytes(),
                     lv.res_unit.tobytes(),
                     None if lv.t_scale is None else lv.t_scale.tobytes(),
                     float(budget), int(max_iters)))

    @staticmethod
    def _om(lv: LayerVectors, s_eff: np.ndarray) -> np.ndarray:
        """The engines' t_cycles numerator ``(1 - s_eff) * m_dot``
        (pattern-scaled when t_scale is set) — the single expression both
        certificates must share with the engines float-for-float."""
        om = (1.0 - s_eff) * lv.m_dot
        if lv.t_scale is not None:
            om = om * lv.t_scale
        return om

    @staticmethod
    def _rate11(lv: LayerVectors) -> np.ndarray:
        """Per-layer rate at the (1, 1) floor design — the same floats the
        engines' ``thr_of(i, 1, 1)`` computes."""
        t = np.maximum(1.0, np.ceil(DSECache._om(lv, lv.s_eff)))
        with np.errstate(divide="ignore"):
            r = lv.m_dot / (lv.macs * t)
        return np.where(lv.macs > 0, r, np.inf)

    def _layout(self, fp: int, lv: LayerVectors):
        """(flat_N, starts) for this workload: per-layer reachable-N sets
        concatenated, plus ``reduceat`` segment starts."""
        lay = self._nlayout.get(fp)
        if lay is None:
            sets = []
            for mn in lv.max_n.tolist():
                ns = _REACHABLE_N_MEMO.get(mn)
                if ns is None:
                    ns = _REACHABLE_N_MEMO[mn] = _reachable_n(mn)
                sets.append(ns)
            counts = np.array([len(s) for s in sets], dtype=np.int64)
            flat_n = np.array([v for s in sets for v in s], dtype=np.float64)
            starts = np.zeros(len(sets), dtype=np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            lay = self._nlayout[fp] = (flat_n, starts, counts)
        return lay

    def _tvec(self, lv: LayerVectors, s_eff: np.ndarray, flat_n: np.ndarray,
              counts: np.ndarray) -> np.ndarray:
        """Float t over every (layer, reachable N) pair — the same
        ``(1 - s) * m_dot`` product (pattern-scaled) then division the
        engines compute, so equality here is equality of every t either
        engine can produce."""
        om = np.repeat(self._om(lv, s_eff), counts)
        return np.maximum(1.0, np.ceil(om / flat_n))

    def _lookup(self, fp: int, lv: LayerVectors, s_eff: np.ndarray,
                key: bytes) -> Optional[DSEResult]:
        """Exact/warm lookup for one query row; bumps counters and promotes
        warm hits to exact entries. ``None`` means the caller runs cold."""
        exact = self._exact.setdefault(fp, {})
        r = exact.get(key)
        if r is not None:
            self.hits += 1
            return r
        anchors = self._anchors.setdefault(fp, [[], [], [], [], []])
        a_s, a_r11, a_th, a_tv, a_res = anchors
        if not a_s:
            return None
        q_r11 = self._rate11(lv)
        S = np.stack(a_s)
        R = np.stack(a_r11)
        th = np.asarray(a_th)[:, None]
        diff = S != s_eff[None]
        l1 = (R > th) & (q_r11[None] > th)
        need = diff & ~l1               # layers level 1 leaves unproven
        n_need = need.sum(axis=1)
        idx = np.nonzero(n_need == 0)[0]
        if len(idx):
            self.warm_l1 += 1
            r = a_res[int(idx[0])]
            self._insert(fp, lv, s_eff, key, r)
            return r
        # level 2: re-validate the unproven layers' dynamics by t-vector
        # equality, cheapest anchors first, bounded candidate count
        flat_n, starts, counts = self._layout(fp, lv)
        q_tv = self._tvec(lv, s_eff, flat_n, counts)
        for a in np.argsort(n_need, kind="stable")[:self._L2_CANDIDATES]:
            a = int(a)
            layer_ok = np.logical_and.reduceat(a_tv[a] == q_tv, starts)
            if layer_ok[need[a]].all():
                self.warm_l2 += 1
                r = a_res[a]
                self._insert(fp, lv, s_eff, key, r)
                return r
        return None

    def dse_vec(self, lv: LayerVectors, hw: HardwareModel, budget: float,
                *, max_iters: int = 10000, engine: str = "auto") -> DSEResult:
        fp = self._fingerprint(lv, budget, max_iters)
        s_eff = np.ascontiguousarray(lv.s_eff, dtype=np.float64)
        key = s_eff.tobytes()
        r = self._lookup(fp, lv, s_eff, key)
        if r is not None:
            return r
        self.cold_runs += 1
        spe, n, thr, res, trace, frontier, theta_r = _run_dse(
            lv, hw, budget, max_iters, engine)
        designs = _designs_from(spe, n) if self.materialize_designs else []
        r = DSEResult(designs=designs, throughput=thr,
                      resource=res, throughput_per_res=thr / max(res, 1e-9),
                      trace=trace, frontier=frontier, theta_r=theta_r)
        self._insert(fp, lv, s_eff, key, r)
        return r

    def dse_vec_batch(self, lv: LayerVectors, hw: HardwareModel,
                      budget: float, s_eff_batch: np.ndarray,
                      *, max_iters: int = 10000,
                      engine: str = "auto") -> List[DSEResult]:
        """Batched ``dse_vec``: row ``b`` of ``s_eff_batch`` is looked up
        in row order (so within-batch duplicates alias the first
        occurrence, as a serial loop would), and ALL cold rows then run
        through ``incremental_dse_batch`` in one engine invocation — the
        whole point of the proposal-batched path (DESIGN.md §15). Returns
        per-row results bit-identical to ``[dse_vec(row b) for b]``
        (certificate soundness + batch-engine exactness, property-tested).
        ``engine`` here selects the BATCH backend
        (``auto``/``compiled``/``lockstep``)."""
        S = np.ascontiguousarray(np.asarray(s_eff_batch, dtype=np.float64))
        B = S.shape[0]
        out: List[Optional[DSEResult]] = [None] * B
        if B == 0:
            return []
        fp = self._fingerprint(lv, budget, max_iters)
        exact = self._exact.setdefault(fp, {})
        anchors = self._anchors.setdefault(fp, [[], [], [], [], []])
        a_s, a_r11, a_th, a_tv, a_res = anchors
        # warm certificates for the WHOLE batch in one array program
        # against the at-entry anchor snapshot (anchors promoted mid-batch
        # aren't re-scanned; a row that would have certified against one
        # just runs cold — same bits either way, by soundness)
        A = len(a_s)
        if A:
            om11 = (1.0 - S) * lv.m_dot
            if lv.t_scale is not None:
                om11 = om11 * lv.t_scale
            with np.errstate(divide="ignore"):
                t11 = np.maximum(1.0, np.ceil(om11))
                R11 = lv.m_dot / (lv.macs * t11)
            R11 = np.where(lv.macs > 0, R11, np.inf)      # (B, L)
            th = np.asarray(a_th)[None, :, None]
            diff = S[:, None, :] != np.stack(a_s)[None]   # (B, A, L)
            l1 = (np.stack(a_r11)[None] > th) & (R11[:, None, :] > th)
            n_need = (diff & ~l1).sum(axis=2)             # (B, A)
        cold: List[int] = []            # row index of first cold occurrence
        pending: Dict[bytes, int] = {}  # key -> index into ``cold``
        dups: List[Tuple[int, int]] = []
        for b in range(B):
            key = S[b].tobytes()
            r = exact.get(key)
            if r is not None:
                self.hits += 1
                out[b] = r
                continue
            if A:
                idx = np.nonzero(n_need[b] == 0)[0]
                if len(idx):
                    self.warm_l1 += 1
                    r = a_res[int(idx[0])]
                    self._insert(fp, lv, S[b], key, r, rate11=R11[b])
                    out[b] = r
                    continue
                flat_n, starts, counts = self._layout(fp, lv)
                q_tv = self._tvec(lv, S[b], flat_n, counts)
                for a in np.argsort(n_need[b],
                                    kind="stable")[:self._L2_CANDIDATES]:
                    a = int(a)
                    ok = np.logical_and.reduceat(a_tv[a] == q_tv, starts)
                    if ok[diff[b, a] & ~l1[b, a]].all():
                        self.warm_l2 += 1
                        r = a_res[a]
                        self._insert(fp, lv, S[b], key, r,
                                     rate11=R11[b], tvec=q_tv)
                        out[b] = r
                        break
                if out[b] is not None:
                    continue
            ci = pending.get(key)
            if ci is not None:
                self.hits += 1          # a serial loop would exact-hit here
                dups.append((b, ci))
                continue
            pending[key] = len(cold)
            cold.append(b)
        if cold:
            results = incremental_dse_batch(
                lv, hw, budget, S[cold], max_iters=max_iters,
                materialize_designs=self.materialize_designs, engine=engine)
            for b, r in zip(cold, results):
                self.cold_runs += 1
                self._insert(fp, lv, S[b], S[b].tobytes(), r)
            for b, r in zip(cold, results):
                out[b] = r
        for b, ci in dups:
            out[b] = out[cold[ci]]
        return out

    def dse(self, layers: Sequence[LayerCost], hw: HardwareModel,
            budget: float, *, max_iters: int = 10000,
            engine: str = "auto") -> DSEResult:
        """Drop-in cached ``incremental_dse``."""
        return self.dse_vec(hw.layer_vectors(layers), hw, budget,
                            max_iters=max_iters, engine=engine)

    def _insert(self, fp: int, lv: LayerVectors, s_eff: np.ndarray,
                key: bytes, r: DSEResult,
                rate11: Optional[np.ndarray] = None,
                tvec: Optional[np.ndarray] = None) -> None:
        """``rate11``/``tvec`` are computed from ``s_eff`` (NOT from
        ``lv.s_eff`` — batch callers pass a template ``lv``) when a caller
        hasn't already paid for them."""
        exact = self._exact[fp]
        if len(exact) >= self.max_entries:
            exact.clear()                    # epoch reset: searches are
            self._anchors[fp] = [[], [], [], [], []]  # phase-local, old
        exact[key] = r                       # anchors rarely pay off past
        a_s, a_r11, a_th, a_tv, a_res = self._anchors[fp]    # the cap
        flat_n, starts, counts = self._layout(fp, lv)
        if rate11 is None:
            rate11 = self._rate11(replace(lv, s_eff=s_eff))
        if tvec is None:
            tvec = self._tvec(lv, s_eff, flat_n, counts)
        a_s.append(s_eff)
        a_r11.append(rate11)
        a_th.append(r.theta_r)
        a_tv.append(tvec)
        a_res.append(r)


# --------------------------------------------------------------------- #
# Partitioning & reconfiguration (§V-A.4): segment-table DP
# --------------------------------------------------------------------- #
@dataclass
class PartitionResult:
    """One partitioning of a layer pipeline, with both schedule metrics.

    ``throughput`` is the *amortized temporal* rate: ``batch /
    time_per_batch`` where ``time_per_batch`` runs the partitions back to
    back on ONE executor and charges every switch between them — the FPGA
    reconfiguration schedule of §V-A.4. ``steady_throughput`` is the
    *spatial steady-state* rate: all partitions resident at once (one per
    chip), every batch flowing through the full chain, so the pipeline runs
    at the rate of its slowest stage — ``min`` over partition rates and,
    multi-chip, the per-sample ICI hop rates at the cuts. The two coincide
    only for a single partition; see DESIGN.md §10/§11 for when the
    objectives that optimize them pick different cuts.
    """
    cuts: List[int]               # split indices (exclusive prefix ends)
    batch: int
    time_per_batch: float         # cycles, incl. switch/transfer overhead
    throughput: float             # samples/cycle amortized (temporal)
    part_throughput: List[float] = field(default_factory=list)
    part_designs: List[List[DesignPoint]] = field(default_factory=list)
    steady_throughput: float = 0.0  # spatial-pipeline rate: min over
    #                                 partition rates and ICI hop rates
    dse_calls: int = 0            # segment DSE invocations (memoized table)
    objective: str = "sum"        # DP objective that picked the cuts
    chip_budgets: Optional[List[float]] = None   # per-stage DSE budgets
    #                                 (heterogeneous slices; DESIGN.md §13)
    sim_report: Optional[object] = None   # SimReport of the winning
    #                                 candidate when objective="slo"
    fault_reports: Optional[List[object]] = None  # per-fault-scenario
    #                                 SimReports of the winner when the SLO
    #                                 search ran with a fault set


def boundary_activations(layers: Sequence[LayerCost], cut: int) -> float:
    """Activation elements per sample crossing a partition cut.

    A sequential pipeline hands ``layers[cut-1].act_out ==
    layers[cut].act_in`` across the boundary. When the two disagree the
    smaller side is the stream that actually crosses: LM ``act_in``/
    ``act_out`` carry per-layer ``n_apply`` multipliers (a MoE down-proj
    "emits" d_model x active_experts, but the block reduces back to one
    residual stream of width d_model = the next block's ``act_in``), and a
    shared-attention block consumes a concat of the d_model stream. Taking
    ``min`` prices the residual stream, not the intra-block fan-out
    (DESIGN.md §11)."""
    return float(min(layers[cut - 1].act_out, layers[cut].act_in))


class SegmentTable:
    """Memoized per-contiguous-segment DSE frontiers for partitioning.

    Each contiguous segment ``layers[i:j]`` is searched at most ONCE; the
    DP below then reads amortized batch times off the cached frontiers. The
    total segment-DSE count is therefore bounded by L(L+1)/2 regardless of
    how many cut configurations the optimizer considers — unlike SA, whose
    DSE count scales with annealing steps x partitions and which still only
    samples the cut space (DESIGN.md §10).

    A shared ``DSECache`` extends the reuse across *tables*: every
    ``partition_pipeline`` call in one search session (per chip count, per
    objective, per proposal) keys its segment DSEs in the same cache, so a
    segment whose layers' sparsity did not change is never re-searched
    (DESIGN.md §12).
    """

    def __init__(self, layers: Sequence[LayerCost], hw: HardwareModel,
                 budget: float, batch: int, dse_iters: int,
                 cache: Optional[DSECache] = None):
        self.layers = list(layers)
        self.hw, self.budget = hw, budget
        self.batch, self.dse_iters = batch, dse_iters
        self._cache: Dict[Tuple[int, int, float], ParetoFrontier] = {}
        self.dse_calls = 0
        self.shared = cache

    def frontier(self, i: int, j: int,
                 budget: Optional[float] = None) -> ParetoFrontier:
        """Per-segment frontier at ``budget`` (the table's own budget when
        None). Heterogeneous slices query the same segment at several
        per-chip budgets — each (i, j, budget) is searched at most once, and
        a shared ``DSECache`` dedupes across tables by the same key."""
        b = self.budget if budget is None else float(budget)
        key = (i, j, b)
        if key not in self._cache:
            self.dse_calls += 1
            if self.shared is not None:
                r = self.shared.dse(self.layers[i:j], self.hw, b,
                                    max_iters=self.dse_iters)
            else:
                r = incremental_dse(self.layers[i:j], self.hw, b,
                                    max_iters=self.dse_iters)
            self._cache[key] = r.frontier
        return self._cache[key]

    def _best(self, i: int, j: int, budget: Optional[float] = None) -> int:
        b = self.budget if budget is None else float(budget)
        f = self.frontier(i, j, b)
        k = f.best_under(b)
        # infeasible budget: the resource-minimal design still runs (the
        # greedy's own behavior when it cannot afford any growth)
        return 0 if k is None else k

    def throughput(self, i: int, j: int,
                   budget: Optional[float] = None) -> float:
        f = self.frontier(i, j, budget)
        return float(f.thr[self._best(i, j, budget)])

    def time(self, i: int, j: int, budget: Optional[float] = None) -> float:
        thr = self.throughput(i, j, budget)
        return self.batch / thr if thr > 0 else float("inf")

    def designs(self, i: int, j: int,
                budget: Optional[float] = None) -> List[DesignPoint]:
        f = self.frontier(i, j, budget)
        return f.materialize(self._best(i, j, budget))


def _keep_largest(budgets: Sequence[float], p: int) -> List[float]:
    """The ``p`` largest budgets, physical order preserved (ties keep the
    earlier chip) — the chips a ``p``-partition deployment holds on to."""
    idx = sorted(sorted(range(len(budgets)), key=lambda i: -budgets[i])[:p])
    return [budgets[i] for i in idx]


def _better_partition(a: PartitionResult, b: PartitionResult,
                      objective: str) -> bool:
    """Strictly-better comparison across the heterogeneous per-P runs,
    mirroring the DP's own tie rules (maxmin ties prefer the smaller
    amortized batch time; ascending-P iteration keeps remaining ties on
    the fewest chips)."""
    if objective == "maxmin":
        if a.steady_throughput > b.steady_throughput * (1 + 1e-12):
            return True
        if a.steady_throughput < b.steady_throughput * (1 - 1e-12):
            return False
    return a.time_per_batch < b.time_per_batch * (1 - 1e-12)


def partition_pipeline(layers: Sequence[LayerCost], hw: HardwareModel,
                       budget: float, *, n_parts: int, batch: int = 256,
                       reconfig_cycles: float = 5e7, seed: int = 0,
                       dse_iters: int = 300,
                       cut_points: Optional[Sequence[int]] = None,
                       objective: str = "auto",
                       cache: Optional[DSECache] = None,
                       chip_budgets: Optional[Sequence[float]] = None,
                       slo: Optional[object] = None,
                       trace: Optional[object] = None,
                       sim_kw: Optional[dict] = None,
                       _positional: bool = False) -> PartitionResult:
    """Fold the pipeline into at most ``n_parts`` sequential partitions, each
    run with the full per-partition ``budget``. Exact DP over cut positions
    on a memoized per-segment frontier table (one DSE per contiguous
    segment) — replaces the SA loop, which re-ran the full segment DSE on
    every annealing step (kept as ``partition_pipeline_sa``).

    Switch accounting (temporal schedule, ``time_per_batch``): a schedule
    with P resident partitions charges exactly P - 1 *switches* per
    processed batch — the mid-batch program transitions. A single resident
    partition (P = 1) charges none: it is never reconfigured, and reloading
    the first partition for the next batch overlaps with host-side batch
    staging, so neither end of the loop is charged. On a single-chip target
    a switch costs ``reconfig_cycles`` (FPGA full reconfiguration / TPU mesh
    program swap); on a multi-chip ``TPUModel`` (``hw.chips > 1``) each
    partition is resident on its own chip and a switch is instead the ICI
    transfer of the whole batch's boundary activations
    (``TPUModel.ici_transfer_cycles``), and ``n_parts`` is capped at
    ``hw.chips``.

    Metrics: ``throughput`` is the amortized *temporal* rate ``batch /
    time_per_batch`` (partitions time-multiplexed on one executor);
    ``steady_throughput`` is the *spatial* steady-state rate with every
    partition resident simultaneously — ``min`` over partition rates and,
    multi-chip, the per-sample ICI hop rates at the cuts. See the
    ``PartitionResult`` docstring and DESIGN.md §10/§11.

    ``objective`` selects what the DP optimizes:
      * ``"sum"``    — minimize ``time_per_batch`` (the sum-form temporal
        objective; the §V-A.4 reconfiguration schedule).
      * ``"maxmin"`` — maximize ``steady_throughput`` directly (max-min
        over stage and ICI-hop rates; multi-chip only, where the spatial
        schedule is the one actually run). Never worse on
        ``steady_throughput`` than the sum-form pick over the same cut
        space, because it exactly maximizes that metric; ties prefer the
        partition with the smaller ``time_per_batch``.
      * ``"auto"``   — ``"maxmin"`` for a multi-chip ``TPUModel``,
        ``"sum"`` otherwise (DESIGN.md §11).
      * ``"slo"``    — simulation-in-the-loop: build the per-P sum/max-min
        candidate partitions, simulate each against ``trace`` with the
        discrete-event deployment simulator, and pick the best candidate
        that meets the latency SLO (``slo``, a ``repro_torch.sim.slo.SLO`` or a
        p99 target in cycles); extra simulator knobs go through ``sim_kw``.
        Delegates to ``repro_torch.sim.slo.slo_partition_search`` (DESIGN.md §13);
        the returned result carries its winning ``sim_report``.

    ``chip_budgets`` gives each *stage* its own DSE budget on a
    heterogeneous (mixed-generation) slice. Multi-chip only, one entry per
    chip; defaults to ``hw.chip_budgets`` when the ``TPUModel`` declares
    ``chip_lanes``. A deployment with P partitions keeps the P *largest*
    chips (physical order preserved, ties to the earlier chip — a single
    resident partition lands on the largest chip, matching
    ``TPUModel.chip_budget``), and stage ``p`` is searched at the budget
    of the ``p``-th kept chip. Each P is priced by its own exact
    positional DP and the objective-best P wins (DESIGN.md §13;
    property-tested against brute force in ``tests/test_partition_dp.py``).
    ``_positional`` is internal: it marks one of those per-P runs, where
    ``chip_budgets`` lists exactly the kept stage budgets.

    ``cut_points`` restricts the DP to a candidate set of cut indices
    (sorted, in ``1..L-1``); ``None`` allows every position. Deep LM stacks
    pass block boundaries (``perf_model.lm_block_bounds``, optionally
    thinned by ``thin_cut_points``) — the segment table then holds
    O(K^2) DSEs for K candidates instead of O(L^2).

    The DP may use fewer than ``n_parts`` partitions when a switch costs
    more than it saves (or, max-min, when an ICI hop would bottleneck the
    pipeline). ``seed`` is accepted for API compatibility with the SA
    reference and is unused — the DP is deterministic.

    ``cache`` plugs a shared ``DSECache`` into the segment table, so
    repeated partition calls in one session (chip-count sweeps, sum vs
    max-min objectives, per-proposal re-partitioning) reuse every segment
    frontier whose layers did not change (DESIGN.md §12).
    """
    L = len(layers)
    multi_chip = isinstance(hw, TPUModel) and hw.chips > 1
    if objective == "slo":
        from repro_torch.sim.slo import slo_partition_search
        return slo_partition_search(
            layers, hw, budget, slo=slo, trace=trace, n_parts=n_parts,
            batch=batch, reconfig_cycles=reconfig_cycles,
            dse_iters=dse_iters, cut_points=cut_points, cache=cache,
            chip_budgets=chip_budgets, **(sim_kw or {}))
    if slo is not None or trace is not None:
        raise ValueError("slo=/trace= are only read by objective='slo'")
    if objective == "auto":
        objective = "maxmin" if multi_chip else "sum"
    if objective not in ("sum", "maxmin"):
        raise ValueError(f"unknown objective {objective!r}")
    if chip_budgets is None and multi_chip and hw.chip_lanes is not None:
        chip_budgets = hw.chip_budgets
    if chip_budgets is not None:
        if not multi_chip:
            raise ValueError("chip_budgets models per-chip DSE budgets, "
                             "which only exist for a multi-chip TPUModel")
        chip_budgets = [float(b) for b in chip_budgets]
        if not _positional:
            if len(chip_budgets) != hw.chips:
                raise ValueError(f"chip_budgets has {len(chip_budgets)} "
                                 f"entries for {hw.chips} chips")
            if len(set(chip_budgets)) > 1:
                # heterogeneous: a P-partition deployment keeps the P
                # largest chips, so each P gets its own positional DP run
                # pinned to EXACTLY P partitions (a smaller partition count
                # is its own loop iteration with its own kept set — letting
                # an inner run fall back to fewer stages would price them
                # at a prefix of the wrong kept set). One shared cache —
                # the segment frontiers are reused across runs. The loop
                # stops at the cut space's capacity so no run is silently
                # capped below its kept-set size.
                shared = DSECache() if cache is None else cache
                kw = dict(batch=batch, reconfig_cycles=reconfig_cycles,
                          dse_iters=dse_iters, cut_points=cut_points,
                          objective=objective, cache=shared)
                cp_n = len(set(int(c) for c in cut_points)) \
                    if cut_points is not None else max(L - 1, 0)
                p_max = max(1, min(n_parts, hw.chips, cp_n + 1))
                best = None
                for p in range(1, p_max + 1):
                    r = partition_pipeline(
                        layers, hw, budget, n_parts=p,
                        chip_budgets=_keep_largest(chip_budgets, p),
                        _positional=True, **kw)
                    if best is None or _better_partition(r, best, objective):
                        best = r
                return best
    if objective == "maxmin" and not multi_chip:
        raise ValueError("objective='maxmin' optimizes the spatial "
                         "steady-state rate, which only exists for a "
                         "multi-chip TPUModel (chips > 1)")
    if cut_points is None:
        cands = list(range(L + 1))
    else:
        cp = sorted(set(int(c) for c in cut_points))
        if cp and not (1 <= cp[0] and cp[-1] <= L - 1):
            raise ValueError(f"cut_points must lie in 1..{L - 1}")
        cands = [0] + cp + [L]
    m = len(cands)                # candidate boundaries incl. 0 and L
    n_parts = min(n_parts, m - 1, hw.chips) if multi_chip \
        else min(n_parts, m - 1)
    if chip_budgets is not None:
        n_parts = min(n_parts, len(chip_budgets))
    n_parts = max(n_parts, 1)
    seg = SegmentTable(layers, hw, budget, batch, dse_iters, cache=cache)

    def stage_budget(p: int) -> float:
        """DSE budget of stage ``p`` (1-indexed): the uniform ``budget``, or
        the stage's resident chip on a heterogeneous slice."""
        return chip_budgets[p - 1] if chip_budgets is not None else budget

    def switch_cost(cut: int) -> float:
        """Cycles charged for the transition at cut position ``cut``."""
        if multi_chip:
            n_bytes = batch * boundary_activations(layers, cut) * ACT_BYTES
            return hw.ici_transfer_cycles(n_bytes)
        return reconfig_cycles

    def hop_rate(cut: int) -> float:
        """Samples/cycle one ICI hop sustains at cut position ``cut``."""
        cyc = hw.ici_transfer_cycles(boundary_activations(layers, cut)
                                     * ACT_BYTES)
        return 1.0 / cyc if cyc > 0 else float("inf")

    INF = float("inf")
    if objective == "sum":
        # T[p][b]: min cycles for layers[:cands[b]] as exactly p partitions
        # (+ their switches); the DP walks candidate boundaries only.
        T = [[INF] * m for _ in range(n_parts + 1)]
        T[0][0] = 0.0
        back = [[-1] * m for _ in range(n_parts + 1)]
        for p in range(1, n_parts + 1):
            # prefixes b < m-1 only feed deeper recursions; the last p level
            # needs the full-pipeline entry alone
            bs = range(p, m) if p < n_parts else (m - 1,)
            for b in bs:
                j = cands[b]
                for a in range(p - 1, b):
                    if T[p - 1][a] == INF:
                        continue
                    i = cands[a]
                    t = T[p - 1][a] + seg.time(i, j, stage_budget(p)) + \
                        (switch_cost(i) if i else 0.0)
                    if t < T[p][b]:
                        T[p][b], back[p][b] = t, a
        # positional hetero runs are pinned to exactly n_parts stages: the
        # kept-chip set is sized for that count, and smaller counts belong
        # to their own outer-loop iteration
        p_opts = (n_parts,) if _positional else range(1, n_parts + 1)
        best_p = min(p_opts, key=lambda p: T[p][m - 1])
        score = [T[p][m - 1] for p in range(n_parts + 1)]
    else:
        # R[p][b]: max achievable min-rate (stage rates and internal ICI
        # hops) for layers[:cands[b]] as exactly p partitions. min() is
        # associative, so the prefix decomposition is exact; +inf seeds the
        # empty prefix. First maximizer wins -> deterministic cuts.
        R = [[-INF] * m for _ in range(n_parts + 1)]
        R[0][0] = INF
        back = [[-1] * m for _ in range(n_parts + 1)]
        for p in range(1, n_parts + 1):
            bs = range(p, m) if p < n_parts else (m - 1,)
            for b in bs:
                j = cands[b]
                for a in range(p - 1, b):
                    if R[p - 1][a] == -INF:
                        continue
                    i = cands[a]
                    r = min(R[p - 1][a],
                            seg.throughput(i, j, stage_budget(p)))
                    if i:
                        r = min(r, hop_rate(i))
                    if r > R[p][b]:
                        R[p][b], back[p][b] = r, a
        # ties on the steady rate prefer the smaller amortized batch time;
        # positional hetero runs are pinned to exactly n_parts stages (see
        # the sum branch)
        p_opts = (n_parts,) if _positional else range(1, n_parts + 1)
        best_rate = max(R[p][m - 1] for p in p_opts)
        tied = [p for p in p_opts
                if R[p][m - 1] >= best_rate * (1 - 1e-12)]

        def _amortized(p: int) -> float:
            total, b = 0.0, m - 1
            for q in range(p, 0, -1):
                a = back[q][b]
                total += seg.time(cands[a], cands[b], stage_budget(q)) + \
                    (switch_cost(cands[a]) if cands[a] else 0.0)
                b = a
            return total
        best_p = min(tied, key=_amortized)
        score = None

    cuts: List[int] = []
    b = m - 1
    for p in range(best_p, 0, -1):
        a = back[p][b]
        if a > 0:
            cuts.append(cands[a])
        b = a
    cuts.reverse()
    bounds = [0] + cuts + [L]
    part_thr = [seg.throughput(a, b, stage_budget(s + 1))
                for s, (a, b) in enumerate(zip(bounds, bounds[1:]))]
    part_designs = [seg.designs(a, b, stage_budget(s + 1))
                    for s, (a, b) in enumerate(zip(bounds, bounds[1:]))]
    steady = min(part_thr) if part_thr else 0.0
    if multi_chip:
        for c in cuts:
            steady = min(steady, hop_rate(c))
    total = sum(seg.time(a, b, stage_budget(s + 1))
                for s, (a, b) in enumerate(zip(bounds, bounds[1:]))) + \
        sum(switch_cost(c) for c in cuts)
    if objective == "sum":
        assert abs(total - score[best_p]) <= 1e-9 * max(total, 1.0)
    return PartitionResult(cuts=cuts, batch=batch, time_per_batch=total,
                           throughput=batch / total if total > 0 else 0.0,
                           part_throughput=part_thr,
                           part_designs=part_designs,
                           steady_throughput=steady,
                           dse_calls=seg.dse_calls,
                           objective=objective,
                           chip_budgets=None if chip_budgets is None
                           else [stage_budget(s + 1)
                                 for s in range(len(bounds) - 1)])


def partition_pipeline_sa(layers: Sequence[LayerCost], hw: HardwareModel,
                          budget: float, *, n_parts: int, batch: int = 256,
                          reconfig_cycles: float = 5e7, seed: int = 0,
                          dse_iters: int = 300) -> PartitionResult:
    """Pre-DP SA-over-cuts implementation, retained as the comparison
    baseline (benchmarks/dse_bench.py, tests/test_partition_dp.py). Re-runs
    the segment DSE inside every annealing energy evaluation — the cost the
    memoized segment table removes. Uses the same switch accounting as
    ``partition_pipeline`` (P - 1 switches per processed batch) so the two
    optimize an identical objective over exactly ``n_parts`` partitions."""
    L = len(layers)
    n_parts = min(n_parts, L)

    def eval_cuts(cuts):
        total = 0.0
        prev = 0
        for c in list(cuts) + [L]:
            part = layers[prev:c]
            if not part:
                return float("inf")
            r = incremental_dse(part, hw, budget, max_iters=dse_iters)
            if r.throughput <= 0:
                return float("inf")
            total += batch / r.throughput
            prev = c
        total += reconfig_cycles * len(list(cuts))
        return total

    if n_parts <= 1:
        t = eval_cuts([])
        return PartitionResult([], batch, t, batch / t)

    init = [round(L * (i + 1) / n_parts) for i in range(n_parts - 1)]

    def neighbor(cuts, rng):
        c = list(cuts)
        i = rng.integers(len(c))
        lo = c[i - 1] + 1 if i else 1
        hi = c[i + 1] - 1 if i + 1 < len(c) else L - 1
        if hi <= lo:
            return c
        c[i] = int(np.clip(c[i] + rng.integers(-2, 3), lo, hi))
        return c

    best, best_e, _ = simulated_annealing(init, eval_cuts, neighbor,
                                          steps=60, seed=seed)
    return PartitionResult(list(best), batch, best_e, batch / best_e)
