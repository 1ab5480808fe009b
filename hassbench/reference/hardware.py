"""The plain reference of a trial's hardware terms: the paper's FPGA
performance model (Eq. 1-3), its design-space exploration (rate balancing
and resource-constrained incrementing, §V-A) and the Eq. 6 terms read off
the exploration's (resource, throughput) frontier, scalar Python.

Given a network's layer table and one proposal's measured per-layer weight
and activation sparsities, ``Hardware.metrics`` returns ``spa`` (the
weight-count-weighted mean of (s_w + s_a) / 2 over prunable layers),
``thr`` (images/s at the full DSP budget), ``eff`` (thr per DSP),
``thr_norm`` and ``dsp`` (their means over the budget fractions 1/4, 1/2,
3/4 and 1: log2(1 + thr / dense thr) / 4, and DSPs / budget).

Floats are ``self.f`` (Python's float64; ``numpy.float32`` is the control):
every rate, score and threshold is rounded to it after each operation.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from hassbench.reference.layers import Layer

FREQ = 250e6                          # the paper's FPGA clock, Hz
BUDGET_FRACS = (0.25, 0.5, 0.75, 1.0)
PRECISIONS = {"float64": float, "float32": np.float32}


class _Cost:
    """One pipeline stage: dense MACs per image (C_l), pairs per dot product
    (M), weight count, prunable or not."""
    __slots__ = ("name", "macs", "m_dot", "weights", "prunable")

    def __init__(self, l: Layer):
        self.name, self.macs, self.weights, self.prunable = \
            l.name, l.macs, l.weights, l.prunable
        self.m_dot = {"conv": l.cin * l.k * l.k, "dwconv": l.k * l.k,
                      "linear": l.cin, "se": l.cin}[l.kind]


def stages(layers: Sequence[Layer]) -> List[_Cost]:
    """The layers that compute (convolutions, depthwise, linear, SE)."""
    return [_Cost(l) for l in layers
            if l.kind in ("conv", "dwconv", "linear", "se")]


def frontier_keep(res: Sequence[float], thr: Sequence[float]) -> List[int]:
    """Non-dominated points of a search path whose last point is the final
    result: drop the points at the final throughput level (relative 1e-9)
    and those no cheaper than it, then keep, in order of resource (ties by
    higher throughput, then first seen), each point that beats every
    cheaper one."""
    f_res, f_thr = res[-1], thr[-1]
    lo, hi = f_thr * (1 - 1e-9), f_thr * (1 + 1e-9)
    idx = [i for i in range(len(res)) if i == len(res) - 1 or not (
        (lo <= thr[i] <= hi) or (res[i] >= f_res and thr[i] <= hi))]
    idx.sort(key=lambda i: (res[i], -thr[i]))
    keep, best = [], -math.inf
    for i in idx:
        if thr[i] > best:
            keep.append(i)
            best = thr[i]
    return keep


class Hardware:
    def __init__(self, layers: Sequence[Layer], budget: float, max_iters: int,
                 precision: str = "float64"):
        self.costs = stages(layers)
        self.budget = budget
        self.max_iters = max_iters
        self.f = PRECISIONS[precision]
        dtype = np.float64 if self.f is float else self.f
        self.array = lambda v: np.asarray(v, dtype)
        res, thr = self.explore([0.0] * len(self.costs))
        self.dense_thr = self.f(thr[-1] * FREQ)

    # ------------------------------------------------------------------ #
    def explore(self, s_eff: Sequence[float]) -> Tuple[List[float], List[float]]:
        """Incrementing from the (1, 1) design of every layer: grow the
        slowest layer (its MACs per engine, or its engines, whichever gains
        more throughput per DSP; MACs first on a tie), shrink every other
        layer to the least design still strictly above the new bottleneck
        rate, and keep the step while it fits the budget, at most
        ``max_iters`` steps; then trim every layer above the bottleneck
        rate (non-strict). -> the (DSPs, images per cycle) of every state
        passed, and of the trimmed result last."""
        f, c = self.f, self.costs
        L = len(c)
        om = [f(f(1.0 - f(s_eff[i])) * c[i].m_dot) for i in range(L)]
        max_n = [max(1, x.m_dot) for x in c]
        max_spe = [max(1, x.macs // max(x.m_dot, 1)) for x in c]

        def rate(i, s, n):
            if not c[i].macs:
                return f(math.inf)
            t = max(1, math.ceil(f(om[i] / f(max(n, 1)))))
            return f(f(s * c[i].m_dot) / f(c[i].macs * t))

        spe, n = [1] * L, [1] * L
        thr = [rate(i, 1, 1) for i in range(L)]
        res = float(L)

        def shrink(lo, skip):
            nonlocal res
            changed = []
            for i in range(L):
                if skip(i):
                    continue
                s_i, n_i = spe[i], n[i]
                while True:
                    if n_i > 1 and rate(i, s_i, n_i // 2) >= lo:
                        n_i //= 2
                    elif s_i > 1 and rate(i, s_i // 2, n_i) >= lo:
                        s_i //= 2
                    else:
                        break
                if (s_i, n_i) != (spe[i], n[i]):
                    changed.append((i, spe[i], n[i]))
                    res += s_i * n_i - spe[i] * n[i]
                    spe[i], n[i] = s_i, n_i
                    thr[i] = rate(i, s_i, n_i)
            return changed

        res_pts, thr_pts = [], []
        for _ in range(self.max_iters):
            cur = min(thr)
            slow = thr.index(cur)
            res_pts.append(res)
            thr_pts.append(cur)
            base = spe[slow] * n[slow]
            best = best_score = None
            cands = []
            if n[slow] < max_n[slow]:
                cands.append((spe[slow], min(n[slow] * 2, max_n[slow])))
            if spe[slow] < max_spe[slow]:
                cands.append((min(spe[slow] * 2, max_spe[slow]), n[slow]))
            for s2, n2 in cands:
                score = f(f(rate(slow, s2, n2) - cur) /
                          f(max(s2 * n2 - base, 1e-9)))
                if best is None or score > best_score:
                    best, best_score = (s2, n2), score
            if best is None:
                break
            res_before = res
            old = (slow, spe[slow], n[slow])
            res += best[0] * best[1] - base
            spe[slow], n[slow] = best
            thr[slow] = rate(slow, *best)
            changed = shrink(f(min(thr) * f(1 + 1e-9)), lambda i: i == slow)
            if res > self.budget:
                for i, s_i, n_i in [old] + changed:
                    spe[i], n[i] = s_i, n_i
                    thr[i] = rate(i, s_i, n_i)
                res = res_before
                break
        theta = min(thr)
        hi = f(theta * f(1 + 1e-9))
        bottleneck = [r <= hi for r in thr]
        shrink(f(theta * f(1 - 1e-12)), lambda i: bottleneck[i])
        res_pts.append(res)
        thr_pts.append(min(thr))
        return res_pts, thr_pts

    def metrics(self, s_w: Sequence[float], s_a: Sequence[float]
                ) -> Dict[str, float]:
        """One proposal's terms from its measured sparsities (one value per
        prunable layer, in layer order)."""
        f = self.f
        s_eff, num, den, i = [], f(0.0), f(0.0), 0
        for c in self.costs:
            if c.prunable:
                sw, sa = f(float(s_w[i])), f(float(s_a[i]))
                i += 1
                s_eff.append(f(1.0 - f(f(1.0 - sw) * f(1.0 - sa))))
                num = f(num + f(f(f(sw + sa) / 2) * c.weights))
                den = f(den + c.weights)
            else:
                s_eff.append(f(0.0))
        res_pts, thr_pts = self.explore(s_eff)
        keep = frontier_keep(res_pts, thr_pts)
        a = self.array
        res = a([res_pts[k] for k in keep])
        thr = a([thr_pts[k] for k in keep]) * a(FREQ)
        thr_norm = np.log2(a(1.0) + thr / a(max(self.dense_thr, 1e-9))) \
            / a(4.0)
        dsp = res / a(max(self.budget, 1e-9))

        def best_under(b):
            return max(int(np.searchsorted(res, b, side="right")) - 1, 0)

        tn = [thr_norm[best_under(frac * self.budget)] for frac in BUDGET_FRACS]
        dp = [dsp[best_under(frac * self.budget)] for frac in BUDGET_FRACS]
        k = best_under(self.budget)
        return {"spa": float(f(num / f(max(den, 1e-9)))),
                "thr": float(thr[k]),
                "thr_norm": float(np.mean(a(tn))),
                "dsp": float(np.mean(a(dp))),
                "eff": float(f(thr[k] / f(max(res[k], 1e-9))))}
