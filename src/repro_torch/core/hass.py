"""HASS: Hardware-Aware Sparsity Search (§V-B) — the paper's main loop.

TPE proposes per-layer (S_w, S_a) targets; we one-shot prune, calibrate, run
the DSE (rate balancing + incrementing) under a resource budget, and score

    f = f_acc + λ1 f_spa + λ2 f_thr − λ3 f_dsp        (Eq. 6)

``hardware_aware=False`` drops the hardware terms (λ2 = λ3 = 0) — the
"software metrics only" baseline of Fig. 5.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import InitVar, dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import pruning
from repro_torch.core.dse import (DSECache, ParetoFrontier, engine_dispatch_stats,
                            incremental_dse)
from repro_torch.obs.trace import get_tracer
from repro_torch.core.perf_model import (FPGAModel, HardwareModel, LayerCost,
                                   LayerVectors, TPUModel, lm_layer_costs,
                                   pair_sparsity, tile_quantize_sparsity)
from repro_torch.core.tpe import TPE, kde_engine_stats

#: ``DSECache`` counters whose change an ``evaluate.dse`` span carries
DSE_COUNTERS = ("hits", "warm_l1", "warm_l2", "cold_runs")


@dataclass
class Lambdas:
    """Eq. 6 normalizing hyper-parameters (heuristic, per the paper).
    thr=0.5 keeps the hardware term subordinate to accuracy — with thr=1.0
    a 10-iteration search can prefer a degenerate zero-accuracy corner.

    ``lat`` weights the simulated serving-latency term (DESIGN.md §13):
    when an evaluator reports ``lat`` (tail latency / SLO target, e.g.
    ``repro_torch.sim.slo.SimLatencyEvaluator``) a hardware-aware search
    subtracts ``lat * m["lat"]``. The default 0.0 leaves every existing
    search bit-identical.

    ``meas`` weights the measured-kernel-cost term (DESIGN.md §16): when an
    evaluator is built with ``pattern_costs`` (decode factors from the
    ``kernels.kernel_costs`` microbench) it reports ``meas`` — the
    weight-fraction-weighted measured relative cycle estimate of the
    realized pattern assignment — and a hardware-aware search subtracts
    ``meas * m["meas"]``. Default 0.0 = modeled Eq. 1 costs only,
    bit-identical to the pre-pattern search."""
    spa: float = 0.3
    thr: float = 0.5
    dsp: float = 0.3
    lat: float = 0.0
    meas: float = 0.0


@dataclass
class Trial:
    x: np.ndarray
    score: float
    metrics: Dict[str, float]


@dataclass
class SearchResult:
    best_x: np.ndarray
    best_score: float
    best_metrics: Dict[str, float]
    trials: List[Trial] = field(default_factory=list)

    def history(self, key: str) -> List[float]:
        return [t.metrics.get(key, float("nan")) for t in self.trials]

    def running_best(self, key: str) -> List[float]:
        """Metric of the best-scoring trial so far, per iteration (Fig. 5)."""
        out, best, bestscore = [], float("nan"), -np.inf
        for t in self.trials:
            if t.score > bestscore:
                bestscore, best = t.score, t.metrics.get(key, float("nan"))
            out.append(best)
        return out


def hass_search(evaluate: Callable[[np.ndarray], Dict[str, float]],
                n_layers: int, *, iters: int = 96,
                hardware_aware: bool = True,
                lambdas: Optional[Lambdas] = None,
                s_max: float = 0.95, seed: int = 0,
                include_act: bool = True,
                batch_size: Optional[int] = None,
                liar: Optional[str] = "min",
                x0: Optional[np.ndarray] = None,
                recorder=None) -> SearchResult:
    """Search per-layer sparsity targets.

    evaluate(x) must return a dict with keys:
      acc   in [0,1] — accuracy proxy (agreement with the dense model)
      spa   in [0,1] — achieved average sparsity
      thr   >0       — modeled throughput (samples/s), normalized by caller
      dsp   >0       — resource utilization fraction in [0,1]
    and may report ``lat`` (simulated tail latency / SLO target, e.g. from
    ``repro_torch.sim.slo.SimLatencyEvaluator``) — subtracted with weight
    ``lambdas.lat`` in a hardware-aware search (DESIGN.md §13).
    x layout: [s_w_0..s_w_{L-1}] (+ [s_a_0..s_a_{L-1}] when include_act)
    (+ [pattern_0..pattern_{P-1}] categorical dims when the evaluator
    exposes ``n_pattern_dims > 0`` — DESIGN.md §16).

    ``batch_size`` switches to the batched frontier (DESIGN.md §8): each
    round asks the TPE for a batch of proposals and scores them through
    ``evaluate.evaluate_batch(xs)`` when the evaluator provides it (one
    batched DSE for the whole round instead of one per trial), falling back
    to per-proposal ``evaluate(x)``. Size-1 rounds always use plain
    ``evaluate``, so ``batch_size=1`` replays the serial search
    trial-for-trial at a fixed seed for ANY evaluator; ``None`` runs the
    serial search, the same loop in rounds of one.

    ``liar`` selects the batch proposal protocol (``TPE.ask_batch``):
    ``"min"`` (default) runs constant-liar parallel TPE — batch members
    are proposed sequentially against provisional worst-score tells, so one
    round covers distinct basins instead of resampling one mode
    (DESIGN.md §12); ``None`` restores the independent-draw batch.
    ``lambdas`` defaults to a fresh ``Lambdas()`` per call — pass an
    instance to override Eq. 6 weights (concurrent searches never alias
    each other's weights).

    ``x0`` anchors the search: the point is evaluated as trial 0 (consuming
    one of ``iters``) and told to the TPE before any proposal is drawn, so
    a known-good configuration (e.g. the dense network, ``np.zeros(dim)``)
    is always in the trial set and the guided phase explores around it.
    ``None`` (default) changes nothing — proposal streams stay bit-identical.

    ``recorder`` (an ``repro_torch.obs.FlightRecorder``) emits one structured
    JSONL record per trial — proposal, score, metric terms, DSECache and
    engine-dispatch counter deltas (the DSE's and the TPE KDE's), per-phase
    timings — plus run header/footer (DESIGN.md §18). Spans land in the
    process-global tracer when one is installed
    (``repro_torch.obs.use_tracer``). With neither, the loop reads no clock
    and no counter; with either, instrumentation only reads clocks and
    counters, so the trial transcript stays bit-identical in every state
    (gated in ``benchmarks/obs_bench.py``).
    """
    lambdas = Lambdas() if lambdas is None else lambdas
    dim = n_layers * (2 if include_act else 1)
    # pattern axis (DESIGN.md §16): an evaluator with >1 sparsity pattern
    # exposes n_pattern_dims tied categorical variables; they ride at the
    # END of x as TPE categorical dims so the search picks each matrix
    # kind's pattern jointly with its sparsity level. n_pattern_dims == 0
    # (no patterns, or the single-pattern degenerate axis) constructs the
    # exact pre-pattern TPE — bit-identical proposal stream.
    n_pat = int(getattr(evaluate, "n_pattern_dims", 0) or 0)
    if n_pat:
        n_cats = len(evaluate.patterns)
        opt = TPE(
            lo=np.zeros(dim + n_pat),
            hi=np.concatenate([np.full(dim, s_max),
                               np.full(n_pat, float(n_cats))]),
            seed=seed,
            cats=np.concatenate([np.zeros(dim, np.int64),
                                 np.full(n_pat, n_cats, np.int64)]))
        dim += n_pat
    else:
        opt = TPE(lo=np.zeros(dim), hi=np.full(dim, s_max), seed=seed)
    result = SearchResult(best_x=np.zeros(dim), best_score=-np.inf,
                          best_metrics={})
    def record(x: np.ndarray, m: Dict[str, float]) -> float:
        score = m["acc"] + lambdas.spa * m["spa"]
        if hardware_aware:
            score += lambdas.thr * m["thr_norm"] - lambdas.dsp * m["dsp"]
            if lambdas.lat and "lat" in m:
                score -= lambdas.lat * m["lat"]
            if lambdas.meas and "meas" in m:
                score -= lambdas.meas * m["meas"]
        m["score"] = score
        result.trials.append(Trial(x=x, score=score, metrics=m))
        if score > result.best_score:
            result.best_score, result.best_x, result.best_metrics = score, x, m
        return score

    # observability (DESIGN.md §18): each phase is timed and counter deltas
    # snapshotted — reads only, never a float the search computes. An
    # installed tracer gets nested spans: ``search`` > ``round`` (a serial
    # search or the ``x0`` trial: ``trial``) > ``propose`` (the ask; none
    # for ``x0``), ``evaluate`` (the evaluator's call), ``tell`` (the tell
    # and scoring) and ``record`` (the recorder's write, in no phase); a
    # batched round adds one ``trial`` span per member over the round's
    # window. The default tracer's ``span`` is a shared no-op, and with no
    # recorder either ``clk`` reads no clock.
    tr = get_tracer()
    clk = tr.now if tr.enabled else \
        time.perf_counter if recorder is not None else (lambda: 0.0)
    cache = getattr(evaluate, "dse_cache", None)
    eval_batch = getattr(evaluate, "evaluate_batch", None)
    kde0 = kde_engine_stats()

    def _snap():
        return (dict(cache.stats()) if cache is not None else {},
                {**engine_dispatch_stats(), **kde_engine_stats()})

    def _observe(base, k, t0, t1, t2, t3, snap):
        """Write round ``result.trials[base:base + k]`` to the recorder.
        Every member gets the round's size, but the shared phase time and
        counter deltas go to the FIRST trial only (zeros elsewhere), so
        footer totals stay the sum of per-trial records."""
        c1, e1 = _snap()
        for j in range(k):
            t = result.trials[base + j]
            recorder.trial(
                index=base + j, x=t.x, score=t.score, metrics=t.metrics,
                cache={key: c1[key] - snap[0].get(key, 0) for key in c1}
                if j == 0 else {},
                engine={key: e1[key] - snap[1].get(key, 0) for key in e1}
                if j == 0 else {},
                phases={"propose": t1 - t0, "evaluate": t2 - t1,
                        "tell": t3 - t2} if j == 0 else
                {"propose": 0.0, "evaluate": 0.0, "tell": 0.0},
                round_size=k)

    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if recorder is not None:
        recorder.header(
            "hass_search", n_layers=n_layers, iters=iters, dim=dim,
            seed=seed, hardware_aware=hardware_aware, s_max=s_max,
            include_act=include_act, batch_size=batch_size, liar=liar,
            evaluator=type(evaluate).__name__)
    with tr.span("search"):
        given = None
        if x0 is not None:
            given = np.asarray(x0, dtype=np.float64).copy()
            if len(given) != dim:
                raise ValueError(
                    f"x0 has {len(given)} dims, search space has {dim}")
        # one round per pass: the ``x0`` trial is a round of one whose
        # proposal is given, a serial search runs rounds of one
        while given is not None or len(result.trials) < iters:
            n = len(result.trials)
            rnd = given is None and batch_size is not None
            k = min(batch_size, iters - n) if rnd else 1
            with tr.span("round") if rnd else tr.span("trial", i=n):
                snap = _snap() if recorder is not None else None
                t0 = t1 = clk()
                if given is not None:
                    xs, given = [given], None
                else:
                    with tr.span("propose"):
                        xs = opt.ask_batch(k, liar=liar)
                    t1 = clk()
                with tr.span("evaluate"):
                    ms = [dict(m) for m in eval_batch(xs)] \
                        if eval_batch is not None and k > 1 \
                        else [dict(evaluate(x)) for x in xs]
                t2 = clk()
                with tr.span("tell"):
                    opt.tell_batch(xs, [record(x, m)
                                        for x, m in zip(xs, ms)])
                t3 = clk()
                with tr.span("record"):
                    if recorder is not None:
                        _observe(n, k, t0, t1, t2, t3, snap)
                if rnd:
                    for j in range(k):
                        tr.add_span("trial", t0, t3, i=n + j)
    if tr.enabled:
        tr.count("search.trials", len(result.trials))
        for key, v in kde_engine_stats().items():
            tr.count(key, v - kde0[key])
    if recorder is not None:
        recorder.footer(best_score=result.best_score)
    return result


#: deployment budgets, as fractions of the DSE budget, that Eq. 6's
#: hardware terms average over (``frontier_hw_metrics``)
BUDGET_FRACS = (0.25, 0.5, 0.75, 1.0)


def frontier_hw_metrics(ht: "HardwareTerms",
                        f: ParetoFrontier) -> Dict[str, float]:
    """Eq. 6 hardware terms read off a DSE frontier, shared by both
    evaluators (DESIGN.md §12): a per-budget scalarization of the WHOLE
    frontier. For each deployment budget ``frac·budget``
    (``BUDGET_FRACS``) take the point actually deployable there
    (``best_under``) and report the MEAN of the per-budget thr_norm and of
    the per-budget resource fraction ``res/budget`` (utilization of the
    AVAILABLE device, the paper's f_dsp — NOT of the frac slice, where every
    greedy design saturates and the λdsp term stops discriminating between
    proposals). Eq. 6 is linear in (thr_norm, dsp), so the search score
    becomes the mean of the per-budget Eq. 6 hardware scores — a proposal
    wins by being good across the budget sweep, not at one cherry-picked
    trade-off. ``thr``/``eff`` stay the full-budget point's values for
    reporting.
    """
    thr_pts, thr_norm_pts, dsp_pts = ht._hw_terms(f.res, f.thr)
    tn = []
    dp = []
    for frac in BUDGET_FRACS:
        k = f.best_under(frac * ht.budget)
        k = 0 if k is None else k       # infeasible budget: the resource-
        tn.append(float(thr_norm_pts[k]))   # minimal design still runs
        dp.append(float(dsp_pts[k]))
    k = f.best_under(ht.budget)
    k = 0 if k is None else k
    return {"thr": float(thr_pts[k]),
            "thr_norm": float(np.mean(tn)),
            "dsp": float(np.mean(dp)),
            "eff": float(thr_pts[k]) / max(float(f.res[k]), 1e-9)}


@dataclass
class HardwareTerms:
    """The hardware half of a trial, one per evaluator: the DSE of a
    realized stack under ``budget`` (through the evaluator's ``DSECache``
    when it has one, ``None`` when its ``accel`` is off) and Eq. 6's
    hardware terms read off its frontier. ``dense_thr``, the unit of
    ``thr_norm``, comes from one DSE of the ``dense`` stack.
    ``dse_engine`` pins the greedy engine ("flat" reproduces seed-path
    wall-clock); ``batch_dse=False`` pins a batch to one DSE a row."""
    hw: HardwareModel
    budget: float
    dse_iters: int
    dse_engine: str
    batch_dse: bool
    cache: Optional[DSECache]
    dense: InitVar[Sequence[LayerCost]]

    def __post_init__(self, dense):
        self.dense_thr = incremental_dse(
            dense, self.hw, self.budget,
            max_iters=self.dse_iters).throughput * self.hw.freq

    def dse(self, row):
        """One row's DSE: a ``LayerVectors`` row through the cache's
        ``dse_vec``; a ``LayerCost`` stack through the cache's ``dse`` or,
        with no cache, a fresh ``incremental_dse``."""
        kw = dict(max_iters=self.dse_iters, engine=self.dse_engine)
        if isinstance(row, LayerVectors):
            return self.cache.dse_vec(row, self.hw, self.budget, **kw)
        if self.cache is not None:
            return self.cache.dse(row, self.hw, self.budget, **kw)
        return incremental_dse(row, self.hw, self.budget, **kw)

    def batched(self, n: int) -> bool:
        """Whether ``n`` rows go through ``dse_batch``: a non-``auto``
        engine pins a serial engine, so it keeps one DSE a row."""
        return n > 1 and self.cache is not None and self.batch_dse \
            and self.dse_engine == "auto"

    def dse_batch(self, rows: Sequence[LayerVectors]) -> List:
        """``[self.dse(row) for row in rows]``, bit for bit (batch-engine
        exactness + certificate soundness, property-tested), with every
        cold row of a group advancing in ONE batched-engine invocation
        (DESIGN.md §15). Rows are grouped by their decode ``t_scale``
        vector in first-seen order, one ``dse_vec_batch`` a group, because
        ``t_scale`` is a template constant, not a per-row input; rows are
        independent, so grouping preserves each row's result exactly, and
        patterned groups take the batch dispatcher's lockstep route
        (DESIGN.md §16)."""
        groups: Dict[Optional[bytes], List[int]] = {}
        for b, lv in enumerate(rows):
            key = None if lv.t_scale is None else lv.t_scale.tobytes()
            groups.setdefault(key, []).append(b)
        out: List = [None] * len(rows)
        for grp in groups.values():
            S = np.stack([rows[b].s_eff for b in grp])
            for b, r in zip(grp, self.cache.dse_vec_batch(
                    rows[grp[0]], self.hw, self.budget, S,
                    max_iters=self.dse_iters)):
                out[b] = r
        return out

    def _hw_terms(self, res: np.ndarray, thr: np.ndarray):
        """(thr in samples/s, thr_norm, dsp) for frontier points, vectorized.
        thr_norm is the log-compressed speedup vs the dense-stack DSE: Eq.
        6's lambda-normalization heuristic keeps the hardware terms
        commensurate with acc in [0, 1]; dsp is the resource fraction."""
        thr_s = thr * self.hw.freq
        thr_norm = np.log2(1.0 + thr_s / max(self.dense_thr, 1e-9)) / 4.0
        return thr_s, thr_norm, res / max(self.budget, 1e-9)

    def terms(self, dse) -> Dict[str, float]:
        """Eq. 6's hardware terms of one DSE result, off its frontier."""
        return frontier_hw_metrics(self, dse.frontier)


# --------------------------------------------------------------------- #
# LM evaluator (the TPU-side setting: deep lm_layer_costs stacks, analytic
# Eq. 6 scoring — DESIGN.md §11)
# --------------------------------------------------------------------- #
def _gaussian_energy_curve(n_grid: int = 257, n_draws: int = 1 << 15,
                           seed: int = 0) -> np.ndarray:
    """``curve[k]`` = fraction of L2 weight energy removed by magnitude-
    pruning the smallest ``k/(n_grid-1)`` fraction of an i.i.d. Gaussian
    weight tensor. Computed once from a fixed-seed sample (no scipy in the
    container, so no closed-form erfinv); interpolated by the evaluator."""
    w2 = np.sort(np.random.default_rng(seed).standard_normal(n_draws) ** 2)
    cum = np.concatenate([[0.0], np.cumsum(w2)]) / w2.sum()
    return np.interp(np.linspace(0.0, 1.0, n_grid),
                     np.arange(n_draws + 1) / n_draws, cum)


def _nm_energy_curve(m: int = pruning.NM_M, n_draws: int = 1 << 13,
                     seed: int = 0):
    """``(s_grid, removed)`` over the N:M grid s = 1 - n/m: fraction of L2
    weight energy removed when every m-group of an i.i.d. Gaussian tensor
    keeps only its top-n magnitudes. Groupwise top-n removes MORE energy
    than unconstrained global magnitude pruning at equal sparsity (the
    structure tax) but far less than tile pruning's uniform fraction — the
    accuracy-side half of the pattern trade-off (DESIGN.md §16). Fixed-seed
    Monte Carlo, like ``_gaussian_energy_curve``; evaluators interpolate,
    and every realizable sparsity lands exactly on a grid node."""
    g = np.random.default_rng(seed).standard_normal((n_draws, m)) ** 2
    g = -np.sort(-g, axis=1)                       # descending per group
    cum = np.cumsum(g, axis=1)                     # top-n kept energy
    kept = np.concatenate([[0.0], cum.sum(axis=0)]) / cum[:, -1].sum()
    removed = (1.0 - kept)[::-1]                   # index: n = m .. 0
    s_grid = 1.0 - np.arange(m, -1, -1) / m        # ascending 0 .. 1
    return s_grid, removed


@dataclass
class LMEvaluator:
    """Eq. 6 metric dict for one sparsity proposal on an LM layer stack.

    The LM path is fully *analytic* (DESIGN.md §11): there are no 671B
    weights in-container, so instead of prune-and-forward the evaluator
    scores

      * ``acc``  — an energy-based proxy: ``exp(-alpha * E)`` where ``E`` is
        the weight-fraction-weighted L2 energy removed by pruning, summed
        over prunable layers. Element-wise magnitude pruning on a Gaussian
        tensor removes the ``_gaussian_energy_curve`` fraction; a
        tile-structured pruner (TPU backend) removes energy ~ proportionally
        to the tile fraction. Monotone decreasing in every sparsity target.
      * ``spa``  — weight-count-weighted mean of (s_w + s_a)/2 (the CNN
        evaluator's convention).
      * ``thr``/``thr_norm``/``dsp``/``eff`` — exactly the CNN path: ONE
        DSE over the sparse stack under the budget, Eq. 6's hardware terms
        read off its frontier (``HardwareTerms``).

    On a ``TPUModel`` the searched target is realized tile-granularly:
    ``s_w`` snaps to the largest achievable whole-tile fraction
    (``tile_quantize_sparsity``) and drives ``s_w_tile`` — the MXU skips
    whole tiles only (DESIGN.md §6). Activation sparsity never skips MXU
    compute, so on TPU ``s_a`` costs accuracy without buying throughput;
    searches there usually run ``include_act=False``.

    ``tie="kind"`` shares one search variable across all blocks per matrix
    kind (wq/wo/moe_up/..., ~10 variables for a 550-entry stack — the TPE
    stays low-dimensional on hundreds-of-matmul pipelines); ``tie="none"``
    searches every prunable layer independently, the paper's CNN granularity.
    ``n_search`` is the per-(s_w|s_a) dimension callers pass to
    ``hass_search``.

    ``accel=True`` (default) runs the search-loop acceleration subsystem
    (DESIGN.md §12): proposals are realized as a vectorized ``s_eff`` swap
    on one ``LayerVectors`` template (no per-call LayerCost churn) and the
    DSE goes through a per-evaluator ``DSECache`` — bit-identical metrics
    to ``accel=False`` (property-tested). ``dse_engine`` pins the greedy
    engine ("flat" reproduces seed-path wall-clock).
    """
    cfg: object
    hw: HardwareModel
    budget: float
    seq_len: int = 1              # sample = token; seq_len scales attn only
    dse_iters: int = 300
    tie: str = "kind"             # kind | none
    alpha: float = 4.0            # acc-proxy decay per unit energy removed
    act_weight: float = 0.5       # relative acc cost of activation clipping
    accel: bool = True            # DSECache + vectorized stack realization
    dse_engine: str = "auto"      # greedy engine (flat pins seed behavior)
    batch_dse: bool = True        # proposal-batched DSE in evaluate_batch
    #                               (False pins the serial per-proposal loop)
    patterns: Optional[tuple] = None   # sparsity-pattern axis, a subset of
    #                               pruning.PATTERNS (DESIGN.md §16). None
    #                               keeps the literal pre-pattern code path;
    #                               ("unstructured",) routes through the
    #                               pattern realization pinned to the seed
    #                               rule (bit-identical metrics, property-
    #                               tested); >1 entries add one tied
    #                               categorical TPE variable per matrix kind
    pattern_costs: Optional[dict] = None   # pattern -> measured decode
    #                               factor c_p >= 1 (kernels.kernel_costs.
    #                               decode_factors). Enables t_scale decode
    #                               cost in Eq. 1 AND the ``meas`` metric

    def __post_init__(self):
        if self.tie not in ("kind", "none"):
            raise ValueError(f"unknown tie mode {self.tie!r}")
        if self.patterns is not None:
            self.patterns = tuple(self.patterns)
            bad = [p for p in self.patterns if p not in pruning.PATTERNS]
            if bad or not self.patterns:
                raise ValueError(f"unknown patterns {bad or self.patterns}")
        self.layers = lm_layer_costs(self.cfg, seq_len=self.seq_len)
        self.prunable = [l for l in self.layers if l.prunable]
        kinds: List[str] = []
        self._group: List[int] = []      # prunable-layer -> search variable
        for l in self.prunable:
            key = l.name.split(".", 1)[-1] if self.tie == "kind" else l.name
            if key not in kinds:
                kinds.append(key)
            self._group.append(kinds.index(key))
        self.group_names = kinds
        self.n_search = len(kinds)
        self.tiled = isinstance(self.hw, TPUModel)
        self._energy = _gaussian_energy_curve()
        self._egrid = np.linspace(0.0, 1.0, len(self._energy))
        wc = np.array([l.weight_count for l in self.prunable], dtype=np.float64)
        self._wfrac = wc / max(wc.sum(), 1.0)
        # vectorized realization state (DESIGN.md §12): the workload
        # constants of the stack never change across proposals, so one
        # LayerVectors template + a per-proposal s_eff swap replaces
        # rebuilding the LayerCost list and re-deriving every constant
        self._lv0 = self.hw.layer_vectors(self.layers)
        self._prunable_idx = np.array(
            [i for i, l in enumerate(self.layers) if l.prunable], np.int64)
        import math

        from repro_torch.core.perf_model import MXU_TILE
        # same tile count tile_quantize_sparsity derives — one constant
        # (needed off-TPU too: hierarchical patterns tile-quantize their
        # tile-level half on any backend)
        self._n_tiles = np.array(
            [math.ceil(l.m_dot / MXU_TILE) *
             math.ceil(max(1, l.weight_count // l.m_dot) / MXU_TILE)
             for l in self.prunable], np.float64)
        # pattern axis state (DESIGN.md §16)
        self.n_pattern_dims = self.n_search \
            if self.patterns is not None and len(self.patterns) > 1 else 0
        self._pattern_factors = {p: 1.0 for p in pruning.PATTERNS}
        if self.pattern_costs:
            self._pattern_factors.update(
                {k: float(v) for k, v in self.pattern_costs.items()})
        if self.patterns is not None:
            self._nm_s_grid, self._nm_curve = _nm_energy_curve()
        self.hardware = HardwareTerms(
            self.hw, self.budget, self.dse_iters, self.dse_engine,
            self.batch_dse, dense=self.layers,
            cache=DSECache(materialize_designs=False) if self.accel else None)
        self.dse_cache = self.hardware.cache
        self.dense_thr = self.hardware.dense_thr

    # ------------------------------------------------------------------ #
    def _split(self, x: np.ndarray):
        """Search vector -> per-prunable-layer (s_w, s_a) targets. Pattern
        dims ride at the END of x and are stripped first, so the
        include_act length test below never misreads a categorical dim as
        an activation target."""
        g = np.asarray(self._group)
        x = np.asarray(x, dtype=np.float64)
        if self.n_pattern_dims and len(x) > self.n_search:
            x = x[:-self.n_pattern_dims]
        s_w = x[:self.n_search][g]
        s_a = x[self.n_search:2 * self.n_search][g] \
            if len(x) >= 2 * self.n_search else np.zeros(len(g))
        return s_w, s_a

    def _pattern_codes(self, x: np.ndarray) -> np.ndarray:
        """Per-prunable-layer index into ``self.patterns`` for one proposal
        (all zeros when the axis is degenerate — a single pattern adds no
        search dims, every layer is pinned to it)."""
        g = np.asarray(self._group)
        if self.n_pattern_dims == 0:
            return np.zeros(len(g), np.int64)
        raw = np.asarray(x, dtype=np.float64)[-self.n_pattern_dims:]
        codes = np.clip(raw.astype(np.int64), 0, len(self.patterns) - 1)
        return codes[g]

    def _realize_pattern(self, x: np.ndarray):
        """Pattern-aware realization (DESIGN.md §16): proposal -> realized
        per-prunable (s_w, s_a), energy removed, effective sparsity, tile
        fraction, decode t_scale, and pattern codes.

        Per-pattern rules (``"unstructured"`` reproduces ``_realize``'s
        floats exactly — the default-pattern bit-identity contract):

          unstructured   tile-quantized s_w on TPU (whole-tile skips, e_w
                         linear in the tile fraction), raw s_w elsewhere
                         (Gaussian magnitude energy curve)
          nm             s_w snaps to the N:M grid floor(s*M)/M; full
                         element sparsity counts on TPU (structured decode
                         a la 2:4 sparse cores) at decode cost c_nm;
                         energy from the groupwise top-n curve
          hierarchical   tile-quantized HALF the budget at tile level, the
                         residual as intra-tile N:M (HighLight-style);
                         energy/e_eff compose multiplicatively
          activation     weights stay dense; the searched s_w converts to
                         extra realized activation sparsity
                         1-(1-s_a)(1-s_w) — free accuracy-wise on the
                         weight side, but buys nothing on a TPU (the MXU
                         never skips dynamic zeros)
        """
        s_w, s_a = self._split(x)
        codes = self._pattern_codes(x)
        L = len(codes)
        M = pruning.NM_M
        sw_c = np.clip(s_w, 0.0, 1.0)
        sw_real = np.zeros(L)
        sa_real = np.array(s_a, dtype=np.float64)
        e_w = np.zeros(L)
        swt = np.zeros(L)                        # tile-level fraction
        tsc = np.ones(L)
        for k, pname in enumerate(self.patterns):
            ii = np.flatnonzero(codes == k)
            if ii.size == 0:
                continue
            if pname == "unstructured":
                if self.tiled:
                    q = np.floor(sw_c[ii] * self._n_tiles[ii]) \
                        / self._n_tiles[ii]
                    sw_real[ii] = q
                    e_w[ii] = q
                    swt[ii] = q
                else:
                    sw_real[ii] = s_w[ii]
                    e_w[ii] = np.interp(s_w[ii], self._egrid, self._energy)
            elif pname == "nm":
                s_nm = np.minimum(np.floor(sw_c[ii] * M), M - 1) / M
                sw_real[ii] = s_nm
                e_w[ii] = np.interp(s_nm, self._nm_s_grid, self._nm_curve)
                tsc[ii] = self._pattern_factors["nm"]
            elif pname == "hierarchical":
                st = np.floor(sw_c[ii] / 2.0 * self._n_tiles[ii]) \
                    / self._n_tiles[ii]
                r = np.clip((sw_c[ii] - st) / np.maximum(1.0 - st, 1e-12),
                            0.0, 1.0)
                s_nm = np.minimum(np.floor(r * M), M - 1) / M
                sw_real[ii] = 1.0 - (1.0 - st) * (1.0 - s_nm)
                e_w[ii] = st + (1.0 - st) * \
                    np.interp(s_nm, self._nm_s_grid, self._nm_curve)
                swt[ii] = st
                tsc[ii] = self._pattern_factors["hierarchical"]
            else:                                # activation
                sa_real[ii] = pruning.act_realize_pattern(sw_c[ii], s_a[ii])
        # effective sparsity: full element s_w on TPU for structured-decode
        # patterns, whole-tile fraction for unstructured/activation; pair
        # sparsity on element-granular (FPGA SPE) backends
        if self.tiled:
            s_eff_p = np.where(
                np.isin(codes, [k for k, p in enumerate(self.patterns)
                                if p in ("nm", "hierarchical")]),
                sw_real, swt)
        else:
            s_eff_p = 1.0 - (1.0 - sw_real) * (1.0 - sa_real)
        s_eff = np.zeros(len(self.layers), dtype=np.float64)
        s_eff[self._prunable_idx] = s_eff_p
        t_full = None
        if np.any(tsc != 1.0):
            t_full = np.ones(len(self.layers), dtype=np.float64)
            t_full[self._prunable_idx] = tsc
        return sw_real, sa_real, e_w, s_eff_p, swt, tsc, s_eff, t_full, codes

    def _realize(self, x: np.ndarray):
        """Proposal -> (realized per-prunable s_w, s_a, full-stack s_eff).

        Vectorized equivalent of reading ``hw.effective_sparsity`` off
        ``sparse_layers(x)`` (bit-identical floats, property-tested):
        tile-quantized ``s_w`` on TPU (whole-tile skips only), pair
        sparsity elsewhere."""
        s_w, s_a = self._split(x)
        if self.tiled:
            s_w = np.floor(np.clip(s_w, 0.0, 1.0) * self._n_tiles) \
                / self._n_tiles
            s_eff_p = s_w
        else:
            s_eff_p = 1.0 - (1.0 - s_w) * (1.0 - s_a)
        s_eff = np.zeros(len(self.layers), dtype=np.float64)
        s_eff[self._prunable_idx] = s_eff_p
        return s_w, s_a, s_eff

    def sparse_layers(self, x: np.ndarray) -> List[LayerCost]:
        """The sparse LayerCost stack one proposal realizes (tile-quantized
        on TPU). Feeds the partitioned multi-chip DP directly. With a
        pattern axis the stack carries each layer's realized pattern and
        decode ``t_scale`` so ``hw.layer_vectors`` reproduces exactly the
        effective sparsity the accelerated path scored."""
        if self.patterns is not None:
            sw_real, sa_real, _, _, swt, tsc, _, _, codes = \
                self._realize_pattern(x)
            out: List[LayerCost] = []
            i = 0
            for l in self.layers:
                if not l.prunable:
                    out.append(l)
                    continue
                out.append(LayerCost(**{
                    **l.__dict__, "s_w": float(sw_real[i]),
                    "s_a": float(sa_real[i]), "s_w_tile": float(swt[i]),
                    "pattern": self.patterns[codes[i]],
                    "t_scale": float(tsc[i])}))
                i += 1
            return out
        s_w, s_a = self._split(x)
        out = []
        i = 0
        for l in self.layers:
            if not l.prunable:
                out.append(l)
                continue
            sw, sa = float(s_w[i]), float(s_a[i])
            i += 1
            if self.tiled:
                sw = tile_quantize_sparsity(sw, l.m_dot, l.weight_count)
                out.append(LayerCost(**{**l.__dict__, "s_w": sw, "s_a": sa,
                                        "s_w_tile": sw}))
            else:
                out.append(LayerCost(**{**l.__dict__, "s_w": sw, "s_a": sa}))
        return out

    def _row(self, x: np.ndarray):
        """One proposal -> (realized per-prunable s_w, s_a, weight energy
        removed, the ``meas`` term or ``None``, its DSE row: a
        ``LayerVectors`` row with ``accel``, the sparse ``LayerCost`` stack
        without). With a pattern axis the DSE row threads the decode
        ``t_scale`` (``LayerVectors.t_scale`` — identical Eq. 1 mapping in
        every engine) and the energies are per pattern; ``meas`` — the
        measured relative cycle estimate sum_l wfrac_l * c_l * (1 -
        s_eff_l) — is reported ONLY when ``pattern_costs`` was provided, so
        a cost-less evaluator emits exactly the seed metric dict (Eq. 6
        term gating, ``Lambdas.meas``)."""
        if self.patterns is not None:
            sw, sa, e_w, s_eff_p, _, tsc, s_eff, t_full, _ = \
                self._realize_pattern(x)
            meas = float(np.dot(self._wfrac, tsc * (1.0 - s_eff_p))) \
                if self.pattern_costs is not None else None
            row = replace(self._lv0, s_eff=s_eff, t_scale=t_full) \
                if self.accel else self.sparse_layers(x)
            return sw, sa, e_w, meas, row
        if self.accel:
            sw, sa, s_eff = self._realize(x)
            row = replace(self._lv0, s_eff=s_eff)
        else:
            row = self.sparse_layers(x)
            sparse = [l for l in row if l.prunable]
            sw = np.array([l.s_w for l in sparse])
            sa = np.array([l.s_a for l in sparse])
        # energy removed: tile pruning drops whole tiles (~uniform energy ->
        # fraction == sw); element pruning drops the smallest-|w| tail
        e_w = sw if self.tiled else np.interp(sw, self._egrid, self._energy)
        return sw, sa, e_w, None, row

    def _finish(self, sw: np.ndarray, sa: np.ndarray, e_w: np.ndarray,
                meas: Optional[float], dse) -> Dict[str, float]:
        """Realized sparsity + DSE result -> the Eq. 6 metric dict (shared
        by the serial and the proposal-batched path, so both produce the
        same floats by construction)."""
        e_a = np.interp(sa, self._egrid, self._energy)
        acc = float(np.exp(-self.alpha *
                           np.dot(self._wfrac, e_w + self.act_weight * e_a)))
        spa = float(np.dot(self._wfrac, (sw + sa) / 2.0))
        m = {"acc": acc, "spa": spa, **self.hardware.terms(dse)}
        if meas is not None:
            m["meas"] = meas
        return m

    def __call__(self, x: np.ndarray) -> Dict[str, float]:
        *realized, row = self._row(x)
        return self._finish(*realized, self.hardware.dse(row))

    def evaluate_batch(self, xs: Sequence[np.ndarray]) -> List[Dict[str, float]]:
        """Proposal-batched path (DESIGN.md §15): realize every proposal's
        DSE row, then score the whole wave through
        ``HardwareTerms.dse_batch`` — cache rows resolve in row order and
        ALL cold rows of a decode ``t_scale`` group advance in one
        batched-engine invocation instead of k serial greedy runs.
        Bit-identical to ``[self(x) for x in xs]``, which it is where
        ``HardwareTerms.batched`` says no."""
        if not self.hardware.batched(len(xs)):
            return [self(x) for x in xs]
        rows = [self._row(x) for x in xs]
        dses = self.hardware.dse_batch([r[-1] for r in rows])
        return [self._finish(*r[:-1], dse) for r, dse in zip(rows, dses)]


# --------------------------------------------------------------------- #
# CNN evaluator (the paper's own setting: ImageNet CNNs on the FPGA model)
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def _float32_convolutions():
    """TF32 off and cuDNN's autotuner off for the block, restoring the
    settings it found. On the card a float32 convolution is TF32 by default,
    and the accuracy proxy and the measured sparsities are float32 results;
    without the autotuner cuDNN picks one algorithm per shape, the same in a
    graph's capture as in the eager pass before it."""
    b = torch.backends
    prev = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark = prev


@dataclass
class CNNEvaluator:
    """Builds the Eq. 6 metric dict for one (S_w, S_a) proposal on a CNN.

    Accuracy proxy: top-1 agreement with the dense reference on a calibration
    batch (no ImageNet at hand; the search structure is unchanged).

    The prune + clipped stats forward runs on the device that holds
    ``params`` and ``images`` (the card, unless the caller built them on the
    CPU) as ONE program for a whole batch of proposals, the JAX package's
    vmapped ``_eval_batch`` / ``_eval_p_batch``: every proposal's pruned
    weights side by side, grouped convolutions over them
    (``models.cnn.forward_batched``), and per prunable layer one launch of
    the ``act_clip_count`` kernel's batched entry, which reads each
    proposal's tau from device memory. On the card each batch shape (and
    the pattern program apart from the seed one) is run eagerly once, then
    captured into a CUDA graph over static input buffers and replayed from
    then on; on the CPU the same program runs eagerly. A serial call is the
    shape-1 program. ``evaluate_batch`` pads a ragged batch up to a shape
    already built, by the JAX package's rule. The perf model, the DSE and
    Eq. 6 are numpy on the host. Scalars follow the JAX package's float32
    arithmetic so that the measured sparsities agree with it on the same
    parameters.

    ``accel=True`` (default) enables the search-loop acceleration subsystem:
    per-layer sorted-|w| tables turn every tau_w quantile into an O(1)
    gather (weights are constant across a search), and the DSE runs through a
    per-evaluator ``DSECache``. The DSE and Eq. 6's hardware terms are the
    evaluator's ``HardwareTerms``.

    On a ``TPUModel`` (kept as a hardware *model* the search can target) the
    pruner is tile-structured (``pruning.tile_prune``, 128-aligned all-zero
    tiles — the only pattern a tile-skipping backend skips) and
    ``LayerCost.s_w_tile`` is MEASURED from the actually pruned weights
    instead of a synthetic target.
    """
    cfg: object
    params: dict
    images: torch.Tensor
    hw: HardwareModel
    budget: float
    dse_iters: int = 400
    cost_cfg: object = None     # full-res config for C_l (accuracy runs can
                                # use a reduced img_res; layer names match)
    accel: bool = True          # presorted tau tables + DSECache
    dse_engine: str = "auto"    # greedy engine (flat pins seed behavior)
    batch_dse: bool = True      # proposal-batched DSE in evaluate_batch
    patterns: Optional[tuple] = None   # sparsity-pattern axis: None = the
    #                             literal pre-pattern path; ("unstructured",)
    #                             pins every layer to the seed pruner (same
    #                             code path, same floats); >1 entries add one
    #                             categorical TPE variable per prunable layer,
    #                             realized by a per-layer pruner picked from
    #                             the proposal's concrete pattern code
    pattern_costs: Optional[dict] = None   # pattern -> measured decode
    #                             factor; enables t_scale + the ``meas``
    #                             metric

    def __post_init__(self):
        """Under a tracer: an ``evaluator.build`` span over the set-up, and
        inside it ``build.dense_forward``, ``build.act_samples`` (which
        counts ``evaluator.act_sample_elems``), ``build.dense_dse`` and
        ``build.weight_sort``."""
        with get_tracer().span("evaluator.build"):
            self._set_up()

    def _set_up(self):
        from repro_torch.core.perf_model import cnn_layer_costs
        from repro_torch.models import cnn
        tr = get_tracer()
        self._cnn = cnn
        if self.patterns is not None:
            self.patterns = tuple(self.patterns)
            bad = [p for p in self.patterns if p not in pruning.PATTERNS]
            if bad or not self.patterns:
                raise ValueError(f"unknown patterns {bad or self.patterns}")
        self.device = self.images.device
        self.layers = [l for l in cnn_layer_costs(self.cost_cfg or self.cfg)]
        self.prunable = [l for l in self.layers if l.prunable]
        self.names = [l.name for l in self.prunable]
        self.tiled = isinstance(self.hw, TPUModel)
        with torch.no_grad(), _float32_convolutions():
            with tr.span("build.dense_forward"):
                self.dense_logits = cnn.forward(
                    self.cfg, self.params, self.images).cpu().numpy()
                self.dense_pred = torch.from_numpy(
                    self.dense_logits.argmax(-1)).to(self.device)
            # activation magnitude samples per prunable layer (for tau_a
            # quantiles), on the device: a proposal's taus are gathered there
            with tr.span("build.act_samples"):
                samples = self._collect_act_samples()
                self._act_q = torch.from_numpy(np.stack(
                    [samples[n] for n in self.names]).astype(np.float32)
                ).to(self.device)
        with tr.span("build.dense_dse"):
            self.hardware = HardwareTerms(
                self.hw, self.budget, self.dse_iters, self.dse_engine,
                self.batch_dse, dense=self.layers,
                cache=DSECache() if self.accel else None)
        self.dse_cache = self.hardware.cache
        self.dense_thr = self.hardware.dense_thr
        # accel: weights never change across a search, so each layer's
        # sorted |w| is computed ONCE here and every proposal's tau_w is an
        # O(1) gather instead of a re-sort per layer per call
        with tr.span("build.weight_sort"):
            self._asort = {n: pruning.sorted_abs(self.params[n]["w"])
                           for n in self.names} \
                if self.accel and not self.tiled else None

        # pattern axis state
        self.n_pattern_dims = len(self.prunable) \
            if self.patterns is not None and len(self.patterns) > 1 else 0
        self._pattern_factors = {p: 1.0 for p in pruning.PATTERNS}
        if self.pattern_costs:
            self._pattern_factors.update(
                {k: float(v) for k, v in self.pattern_costs.items()})
        # the degenerate ("unstructured",) axis routes through the seed
        # pruner itself (codes are all zero and unstructured IS the seed
        # pruner); any other axis dispatches per layer on the pattern code
        self._needs_pattern_eval = self.patterns is not None and \
            self.patterns != ("unstructured",)
        # batch-shape bucketing state, the JAX package's: ``batch_shapes``
        # records every batch shape handed to the batched program (on the
        # card: every graph ``evaluate_batch`` has built); ragged batches pad
        # up to a shape already built when one is close enough
        self.batch_shapes: set = set()
        self.padded_batches: int = 0
        #: proposals evaluated so far (padding rows not counted)
        self.stats_forwards: int = 0
        #: batched passes run so far: one ``act_clip_count`` launch per
        #: prunable layer each when the activations are on the card
        self.stats_passes: int = 0
        #: (pattern program?, batch shape) -> (CountedGraph, static inputs,
        #: static output); the card's graphs share one memory pool
        self._graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.graphs_captured: int = 0
        self.capture_s: float = 0.0
        #: device memory the graphs' pool holds (growth of the allocator's
        #: reserved bytes over each capture, the cache emptied around it)
        self.graph_pool_bytes: int = 0

    # ------------------------------------------------------------------ #
    # the device half: one prune + clipped stats forward for B proposals
    # ------------------------------------------------------------------ #
    def _prune_unstructured(self, n: str, w: torch.Tensor, s: torch.Tensor):
        """(B,) sparsities -> (B pruned copies of w, measured all-zero-tile
        fraction (B,), zero off the tiled model)."""
        if self.tiled:
            return pruning.tile_prune(w, s)
        tau_w = pruning.threshold_for_sparsity_sorted(self._asort[n], s) \
            if self._asort is not None else \
            pruning.threshold_for_sparsity(w, s)
        return pruning.prune_tensor(w, tau_w), torch.zeros_like(s)

    def _prune_pattern(self, pname: str, n: str, w: torch.Tensor,
                       s: torch.Tensor):
        """One layer's pruner for a concrete pattern name, over (B,)
        float32 sparsities (the JAX package's traced scalars)."""
        if pname == "unstructured":
            return self._prune_unstructured(n, w, s)
        if pname == "nm":
            return (pruning.nm_prune(w, pruning.nm_keep_for_sparsity(s)),
                    torch.zeros_like(s))
        if pname == "hierarchical":
            # half the budget tile-level, residual intra-tile N:M
            r = torch.clamp(s / (2.0 - s), 0.0, 1.0)
            return pruning.hierarchical_prune(
                w, s / 2.0, pruning.nm_keep_for_sparsity(r))
        return w.expand((s.numel(),) + tuple(w.shape)), torch.zeros_like(s)

    @_float32_convolutions()
    def _device_pass(self, s_w: torch.Tensor, s_a: torch.Tensor,
                     codes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The batched program: (B, L) float32 ``s_w`` and ``s_a`` and (B, L)
        int64 pattern ``codes`` (``None``: the seed pruner everywhere), all
        on the device -> (B, 1 + 3L) float32 rows of accuracy, achieved s_w,
        measured s_a and measured all-zero-tile fraction. No host value
        enters it, so a CUDA graph captures it whole. The pattern program
        computes every branch per layer and selects per proposal by code,
        as the vmapped ``lax.switch`` does."""
        B, nq = s_w.shape[0], self._act_q.shape[1]
        act_code = self.patterns.index("activation") \
            if codes is not None and "activation" in self.patterns else -1
        weights, achieved, tile_fracs, taus = {}, [], [], {}
        for i, n in enumerate(self.names):
            w = self.params[n]["w"]
            sw_i, sa_i = s_w[:, i], s_a[:, i]
            if codes is None:
                w2, swt = self._prune_unstructured(n, w, sw_i)
            else:
                code = codes[:, i]
                if act_code >= 0:
                    # activation pattern: the weight budget converts to
                    # extra realized activation sparsity
                    sa_i = torch.where(
                        code == act_code, 1.0 - (1.0 - sa_i) *
                        (1.0 - torch.clamp(sw_i, 0.0, 1.0)), sa_i)
                for k, pname in enumerate(self.patterns):
                    wk, sk = self._prune_pattern(pname, n, w, sw_i)
                    if k == 0:
                        w2, swt = wk, sk
                    else:
                        sel = code == k
                        w2 = torch.where(sel.reshape((B,) + (1,) * w.dim()),
                                         wk, w2)
                        swt = torch.where(sel, sk, swt)
            weights[n] = w2
            achieved.append((w2 == 0).reshape(B, -1).sum(
                1, dtype=torch.float32) / w.numel())
            tile_fracs.append(swt)
            # float32 product truncated, as the JAX package computes it
            qidx = torch.clamp((sa_i * nq).to(torch.int32), 0, nq - 1)
            taus[n] = self._act_q[i].gather(0, qidx.to(torch.int64))
        logits, stats = self._cnn.forward_batched(self.cfg, self.params,
                                                  weights, self.images, taus)
        acc = (logits.argmax(-1) == self.dense_pred[:, None]).sum(
            0, dtype=torch.float32) / logits.shape[0]
        return torch.cat([acc[:, None], torch.stack(achieved, 1),
                          torch.stack([stats[n] for n in self.names], 1),
                          torch.stack(tile_fracs, 1)], 1)

    def _build(self, key, inputs) -> torch.Tensor:
        """The first pass of a batch shape on the card: run the program
        eagerly on a side stream (cuDNN and the allocator settle; this
        pass's result is the call's), then capture it into a CUDA graph
        over the static ``inputs``, in the evaluator's memory pool."""
        from repro_torch.kernels.graph import warm_and_capture
        t0 = time.perf_counter()
        with get_tracer().span("pass.build"):
            graph, out, static_out, grew = warm_and_capture(
                lambda: self._device_pass(*inputs), self._pool, self.device)
        self.graph_pool_bytes += grew
        self._graphs[key] = (graph, inputs, static_out)
        self.graphs_captured += 1
        self.capture_s += time.perf_counter() - t0
        return out

    @torch.no_grad()
    def _pass(self, s_w: np.ndarray, s_a: np.ndarray,
              codes: Optional[np.ndarray], n_real: int):
        """One batched pass over (B, L) float32 ``s_w``, ``s_a`` and (B, L)
        ``codes`` (``None``: the seed program) -> (acc (B,), achieved s_w,
        measured s_a, measured tile fraction (B, L)), numpy, from one host
        copy. ``n_real`` of the B rows are proposals, the rest padding.
        Under a tracer: an ``evaluate.pass`` span, a ``pass.readback``
        span around the blocking copy of the rows, and the counters
        ``pass.clip_launches``, the batched clip kernel's launches in the
        pass (one per prunable layer on the card, none on the CPU), and
        ``pass.conv_gemms``, its convolutions that ran as one product (one
        per 1 x 1 stride-1 layer where B > 1, on any device)."""
        tr = get_tracer()
        with tr.span("evaluate.pass"):
            if tr.enabled:
                clips = kernels.launch_counts()["act_clip_count_batched"]
                gemms = kernels.product_counts()["conv_gemm"]
            host = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                    (s_w, s_a) + (() if codes is None else
                                  (codes.astype(np.int64),))]
            if self.device.type != "cuda":
                out = self._device_pass(*host)
            else:
                key = (codes is not None, s_w.shape[0])
                built = self._graphs.get(key)
                if built is None:
                    out = self._build(key, [t.to(self.device) for t in host])
                else:
                    graph, inputs, out = built
                    for dst, src in zip(inputs, host):
                        dst.copy_(src)
                    graph.replay()
            with tr.span("pass.readback"):
                out = out.cpu().numpy()
            if tr.enabled:
                tr.count("pass.clip_launches", kernels.launch_counts()[
                    "act_clip_count_batched"] - clips)
                tr.count("pass.conv_gemms", kernels.product_counts()[
                    "conv_gemm"] - gemms)
        self.stats_passes += 1
        self.stats_forwards += n_real
        L = len(self.names)
        return (out[:, 0], out[:, 1:1 + L], out[:, 1 + L:1 + 2 * L],
                out[:, 1 + 2 * L:1 + 3 * L])

    def _eval(self, s_w: np.ndarray, s_a: np.ndarray,
              codes: Optional[np.ndarray] = None):
        """One proposal through the shape-1 program: -> (acc, achieved s_w,
        measured s_a, measured tile fraction), numpy. ``codes`` selects each
        layer's pattern (``None``: the seed pruner everywhere)."""
        acc, sw, sa, swt = self._pass(
            s_w[None], s_a[None], None if codes is None else codes[None], 1)
        return acc[0], sw[0], sa[0], swt[0]

    def _collect_act_samples(self) -> Dict[str, np.ndarray]:
        """|activation| quantiles at each prunable layer's input (dense run):
        the calibration pass that maps target S_a -> clip threshold tau_a.
        Under a tracer the counter ``evaluator.act_sample_elems`` adds the
        elements copied to the host."""
        cnn = self._cnn
        tr = get_tracer()
        _, outs = cnn.forward(self.cfg, self.params, self.images,
                              return_intermediates=True)
        specs = cnn.build_specs(self.cfg)
        last = cnn.INPUT
        samples = {}
        for s in specs:
            inp_name = s.input_from or last
            if s.prunable:
                flat = np.abs(outs[inp_name].to("cpu", torch.float32)
                              .numpy()).reshape(-1)
                samples[s.name] = np.quantile(flat, np.linspace(0, 0.999, 256))
                tr.count("evaluator.act_sample_elems", flat.size)
            last = s.name
        return samples

    def _split(self, x: np.ndarray):
        """Search vector -> per-prunable-layer (s_w, s_a), float32."""
        L = len(self.prunable)
        x = np.asarray(x, dtype=np.float64)
        if self.n_pattern_dims and len(x) > L:
            x = x[:-self.n_pattern_dims]    # pattern dims ride at the END
        s_w = x[:L].astype(np.float32)
        s_a = x[L:2 * L].astype(np.float32) if len(x) >= 2 * L \
            else np.zeros(L, np.float32)
        return s_w, s_a

    def _pattern_codes(self, x: np.ndarray) -> np.ndarray:
        """Per-prunable-layer index into ``self.patterns`` (all zeros for
        the degenerate single-pattern axis)."""
        L = len(self.prunable)
        if self.n_pattern_dims == 0:
            return np.zeros(L, np.int64)
        raw = np.asarray(x, dtype=np.float64)[-self.n_pattern_dims:]
        return np.clip(raw.astype(np.int64), 0, len(self.patterns) - 1)

    def _sparse_layers(self, sw_meas: np.ndarray, sa_meas: np.ndarray,
                       swt_meas: Optional[np.ndarray] = None,
                       codes: Optional[np.ndarray] = None):
        """Measured per-layer sparsity -> LayerCost pipeline + avg sparsity.
        ``swt_meas`` (TPU path) carries the measured all-zero-tile fraction
        of the actually pruned weights into ``LayerCost.s_w_tile``.
        ``codes`` (pattern axis) stamps each layer's realized pattern and
        decode ``t_scale`` so the perf model prices it per-pattern."""
        layers = []
        spa_num = spa_den = 0.0
        i = 0
        for l in self.layers:
            if l.prunable:
                sw, sa = float(sw_meas[i]), float(sa_meas[i])
                swt = float(swt_meas[i]) if swt_meas is not None else 0.0
                extra = {}
                if codes is not None:
                    pname = self.patterns[int(codes[i])]
                    extra = {"pattern": pname,
                             "t_scale": self._pattern_factors[pname]}
                i += 1
                layers.append(LayerCost(**{**l.__dict__, "s_w": sw,
                                           "s_a": sa, "s_w_tile": swt,
                                           **extra}))
                spa_num += (sw + sa) / 2 * l.weight_count
                spa_den += l.weight_count
            else:
                layers.append(l)
        return layers, spa_num / max(spa_den, 1e-9)

    def _eval_any(self, x: np.ndarray):
        """One prune+forward for one proposal, routed through the pattern
        dispatch when the axis needs it. Returns
        (acc, sw_meas, sa_meas, swt_meas, codes) as numpy."""
        s_w, s_a = self._split(x)
        codes = self._pattern_codes(x) if self.patterns is not None else None
        acc, sw_meas, sa_meas, swt_meas = self._eval(
            s_w, s_a, codes if self._needs_pattern_eval else None)
        return acc, sw_meas, sa_meas, swt_meas, codes

    def sparse_layers(self, x: np.ndarray):
        """The measured sparse LayerCost pipeline for one proposal (one
        prune+forward). Feeds the partitioned multi-chip DSE demo."""
        acc, sw_meas, sa_meas, swt_meas, codes = self._eval_any(x)
        return self._sparse_layers(sw_meas, sa_meas,
                                   swt_meas if self.tiled else None,
                                   codes=codes)[0]

    def _meas_term(self, layers) -> float:
        """Measured relative cycle estimate of one realized assignment:
        weight-fraction-weighted c_l * (1 - s_eff_l) over prunable layers
        (Eq. 6 ``meas``, subtracted with ``Lambdas.meas``)."""
        num = den = 0.0
        for l in layers:
            if not l.prunable:
                continue
            num += l.weight_count * l.t_scale * \
                (1.0 - self.hw.effective_sparsity(l))
            den += l.weight_count
        return num / max(den, 1e-9)

    def _metrics(self, acc: float, sw_meas: np.ndarray, sa_meas: np.ndarray,
                 swt_meas: Optional[np.ndarray] = None,
                 codes: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Measured per-layer sparsity -> perf model (Eq. 1-3) -> one DSE
        (through the ``DSECache`` when accelerated) -> Eq. 6 hardware terms
        off the frontier -> the metric dict."""
        layers, spa = self._sparse_layers(sw_meas, sa_meas, swt_meas,
                                          codes=codes)
        return self._finish(acc, spa, layers, codes,
                            self.hardware.dse(layers))

    def _finish(self, acc: float, spa: float, layers, codes,
                dse) -> Dict[str, float]:
        """The metric dict of one measured row and its DSE result."""
        m = {"acc": acc, "spa": spa, **self.hardware.terms(dse)}
        if codes is not None and self.pattern_costs is not None:
            m["meas"] = self._meas_term(layers)
        return m

    def _metrics_batch(self, accs: np.ndarray, sw_meas: np.ndarray,
                       sa_meas: np.ndarray,
                       swt_meas: Optional[np.ndarray],
                       codes_rows: Optional[np.ndarray] = None
                       ) -> List[Dict[str, float]]:
        """Batched ``_metrics`` tail: the rows' measured stacks go to
        ``HardwareTerms.dse_batch`` together (the workload constants are
        per-layer dense facts, identical across rows). Bit-identical to the
        per-row ``_metrics`` loop (property-tested)."""
        B = len(accs)
        codes = [None] * B if codes_rows is None else codes_rows
        rows = [self._sparse_layers(sw_meas[b], sa_meas[b],
                                    swt_meas[b] if swt_meas is not None
                                    else None, codes=codes[b])
                for b in range(B)]
        dses = self.hardware.dse_batch(
            [self.hw.layer_vectors(layers) for layers, _ in rows])
        return [self._finish(float(accs[b]), rows[b][1], rows[b][0],
                             codes[b], dses[b]) for b in range(B)]

    def _scored(self, score: Callable[[], list]) -> list:
        """``score()``, the host half of a call (perf model, DSE, Eq. 6),
        inside an ``evaluate.dse`` span; under a tracer its args hold the
        change of ``DSECache``'s counters over the span."""
        tr = get_tracer()
        cache = self.dse_cache
        if not tr.enabled or cache is None:
            with tr.span("evaluate.dse"):
                return score()
        before = cache.stats()
        with tr.span("evaluate.dse") as span:
            out = score()
            after = cache.stats()
            span.args.update({k: after[k] - before[k]
                              for k in DSE_COUNTERS})
        return out

    def __call__(self, x: np.ndarray) -> Dict[str, float]:
        # 1-2) one-shot prune + accuracy proxy + measured act sparsity
        acc, sw_meas, sa_meas, swt_meas, codes = self._eval_any(x)
        return self._scored(lambda: self._metrics(
            float(acc), sw_meas, sa_meas, swt_meas if self.tiled else None,
            codes=codes))

    def evaluate_batch(self, xs: Sequence[np.ndarray]) -> List[Dict[str, float]]:
        """Score a batch of proposals with ONE batched prune+forward pass,
        then ONE batched DSE over the measured-sparsity rows. Feeds
        ``hass_search(batch_size=...)``.

        Batch-shape bucketing (the JAX package's rule): a ragged batch (a
        search's tail round) is padded up to the smallest batch shape
        already built in [B, 2B] by repeating the last proposal; the padded
        rows are dropped before returning, so they never reach
        ``tell_batch`` — a whole fixed-size search builds exactly one
        batched program."""
        if len(xs) == 0:
            return []
        B = len(xs)
        split = [self._split(x) for x in xs]
        s_w = np.stack([s for s, _ in split])
        s_a = np.stack([a for _, a in split])
        codes_rows = np.stack([self._pattern_codes(x) for x in xs]) \
            if self.patterns is not None else None
        codes = codes_rows if self._needs_pattern_eval else None
        # bucket rule: pad up to the smallest already-built shape in [B, 2B]
        # (a one-time build beats repeated >2x padding waste, e.g. a later
        # smaller-batch search on a shared evaluator); otherwise build this
        # exact size
        bigger = [s for s in self.batch_shapes if B <= s <= 2 * B]
        target = min(bigger) if bigger else B
        if B < target:
            def pad(a):
                return np.concatenate([a, np.repeat(a[-1:], target - B, 0)])
            s_w, s_a = pad(s_w), pad(s_a)
            if codes is not None:
                codes = pad(codes)
            self.padded_batches += 1
        self.batch_shapes.add(target)
        accs, sw_meas, sa_meas, swt_meas = self._pass(s_w, s_a, codes, B)
        if self.hardware.batched(B):
            return self._scored(lambda: self._metrics_batch(
                accs[:B], sw_meas[:B], sa_meas[:B],
                swt_meas[:B] if self.tiled else None,
                codes_rows=codes_rows))
        return self._scored(lambda: [
            self._metrics(float(accs[b]), sw_meas[b], sa_meas[b],
                          swt_meas[b] if self.tiled else None,
                          codes=codes_rows[b]
                          if codes_rows is not None else None)
            for b in range(B)])
