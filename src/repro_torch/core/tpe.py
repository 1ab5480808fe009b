"""Tree-structured Parzen Estimator (Bergstra et al., NeurIPS'11) — the
multi-objective search engine of §V-B. Self-contained numpy implementation.

Maximizes f(x) over a box [lo, hi]^D: after ``n_startup`` random trials,
split observations at the γ-quantile into good/bad sets, fit diagonal Parzen
(KDE) densities l(x), g(x), and pick the candidate maximizing l(x)/g(x)
among ``n_ei`` samples drawn from l.

The KDE's squared-distance sums run in compiled C where the host has a C
compiler (``_tpe_ckernel``: numpy's own summation order, so the same
float64 bits), else in numpy; ``kde_engine_stats()`` counts each.

Categorical dims (``cats``; DESIGN.md §16): a dim with cardinality k > 0
lives on [lo, lo+k) and every proposal is snapped to a bin center
``lo + floor(x - lo) + 0.5`` AFTER the continuous machinery runs — the
quantization consumes no RNG, so a search with ``cats=None`` (the default)
replays the pre-categorical stream bit-for-bit, and mixed spaces (some
continuous, some categorical dims) need no special-case sampling: the KDE
simply sees clustered bin centers and reproduces the classic
one-Parzen-per-category TPE behavior in the limit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import _tpe_ckernel
from repro_torch.obs.trace import Counters

# which engine each ``TPE._log_kde`` call's squared-distance sums ran on:
# always-on plain dict increments, read by ``hass_search`` beside the DSE's
# engine dispatch (the recorder's ``engine`` deltas, the tracer's counters)
KDE_ENGINE = Counters("tpe.kde_native", "tpe.kde_numpy")


def kde_engine_stats() -> Dict[str, int]:
    """Cumulative ``_log_kde`` calls by engine for this process."""
    return KDE_ENGINE.as_dict()


def _sq_dist_sums(x: np.ndarray, pts: np.ndarray,
                  bw: np.ndarray) -> np.ndarray:
    """``s[i, j] = sum_d ((x[i, d] - pts[j, d]) / bw[j, d])**2``: compiled
    where it can be, else numpy's expression; the same array either way."""
    s = _tpe_ckernel.sq_dist_sums(x, pts, bw)
    if s is not None:
        KDE_ENGINE.inc("tpe.kde_native")
        return s
    KDE_ENGINE.inc("tpe.kde_numpy")
    d = (x[:, None, :] - pts[None, :, :]) / bw[None]      # (n, m, D)
    return np.sum(d * d, axis=-1)


@dataclass
class TPE:
    lo: np.ndarray
    hi: np.ndarray
    gamma: float = 0.25
    n_startup: int = 10
    n_ei: int = 48
    seed: int = 0
    cats: Optional[np.ndarray] = None   # per-dim cardinality (0=continuous)
    xs: List[np.ndarray] = field(default_factory=list)
    ys: List[float] = field(default_factory=list)

    def __post_init__(self):
        self.lo = np.asarray(self.lo, float)
        self.hi = np.asarray(self.hi, float)
        if self.cats is not None:
            self.cats = np.asarray(self.cats, np.int64)
            if len(self.cats) != len(self.lo):
                raise ValueError(f"cats has {len(self.cats)} dims, "
                                 f"box has {len(self.lo)}")
            k = self.cats > 0
            if not np.allclose(self.hi[k] - self.lo[k], self.cats[k]):
                raise ValueError("categorical dims need hi - lo == "
                                 "cardinality")
            self._cat_mask = k
        self._rng = np.random.default_rng(self.seed)

    def _snap(self, x: np.ndarray) -> np.ndarray:
        """Quantize categorical dims to bin centers. Deterministic, no RNG
        — the continuous path (``cats=None``) returns ``x`` untouched, so
        the pre-categorical stream is bit-identical."""
        if self.cats is None:
            return x
        k = self._cat_mask
        x = np.array(x, float)
        off = np.clip(x[k] - self.lo[k], 0.0, self.cats[k] - 1e-9)
        x[k] = self.lo[k] + np.floor(off) + 0.5
        return x

    @property
    def dim(self) -> int:
        return len(self.lo)

    # -------------------------------------------------------------- #
    def _fit(self):
        """Split observations at the γ-quantile and fit both Parzen densities
        (points + bandwidths). Pure function of (xs, ys) — no RNG use — so a
        batch of asks can share one fit."""
        X = np.stack(self.xs)
        y = np.asarray(self.ys)
        n_good = max(1, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(-y)                        # maximize
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) == 0:
            bad = X
        return good, self._bw(good), bad, self._bw(bad)

    def _propose(self, fit) -> np.ndarray:
        good, bw_good, bad, bw_bad = fit
        cand = self._sample_parzen(good, bw_good, self.n_ei)
        score = self._log_kde(cand, good, bw_good) - \
            self._log_kde(cand, bad, bw_bad)
        return cand[int(np.argmax(score))]

    def ask(self) -> np.ndarray:
        _tpe_ckernel.get_lib()   # build once, before any search needs it
        if len(self.xs) < self.n_startup:
            return self._snap(self._rng.uniform(self.lo, self.hi))
        return self._snap(self._propose(self._fit()))

    def ask_batch(self, k: int,
                  liar: Optional[str] = None) -> List[np.ndarray]:
        """k proposals without intermediate tells.

        ``liar=None`` (the legacy mode): candidates are independent draws
        from the current l(x)/g(x) model (random-restart parallel TPE)
        sharing ONE model fit (the fit consumes no RNG and xs/ys don't change
        inside a batch): each draw advances the RNG, so the batch is diverse,
        and ask_batch(1) is bit-identical to a single ask() — the serial
        search is the batch_size=1 special case (DESIGN.md §8).

        ``liar in ("min", "mean", "max")`` enables the constant-liar
        protocol (Ginsbourger et al.; DESIGN.md §12): after each batch
        member is proposed, it is *provisionally told* to a scratch copy of
        the observations with a constant lie — the worst (min), mean, or
        best (max) score seen so far — and the Parzen model is refit before
        the next member. The pessimistic ``"min"`` lie marks the region
        just proposed as bad, pushing later members away from it: the batch
        spreads over distinct basins instead of resampling one mode.
        Nothing persists: ``tell_batch`` later records the REAL scores, and
        the lies never touch ``self.xs``/``self.ys``. Model refits consume
        no RNG and each member still draws ``n_ei`` candidates, so the RNG
        stream position after ``ask_batch(k, liar=...)`` is identical to
        the legacy mode — downstream draws replay bit-for-bit at a fixed
        seed, whichever protocol ran. ``ask_batch(1, liar=...)`` is a
        single ``ask()`` (there is no one to lie to).
        """
        if liar not in (None, "min", "mean", "max"):
            raise ValueError(f"unknown liar mode {liar!r}")
        _tpe_ckernel.get_lib()   # build once, before any search needs it
        if liar is None or k <= 1 or not self.ys:
            if len(self.xs) < self.n_startup:
                return [self._snap(self._rng.uniform(self.lo, self.hi))
                        for _ in range(k)]
            # one array program per wave (DESIGN.md §15): candidates are
            # drawn member by member (identical RNG stream to k serial
            # ``_propose`` calls) but all k * n_ei are SCORED in one KDE
            # evaluation — ``_log_kde`` reduces strictly per row, so each
            # member's winner is bit-identical to its serial pick, and a
            # ragged tail round (k < batch_size, n_trials not a multiple of
            # batch_size) truncates to exactly k members with the RNG
            # position k serial asks would leave
            good, bw_good, bad, bw_bad = self._fit()
            cands = [self._sample_parzen(good, bw_good, self.n_ei)
                     for _ in range(k)]
            allc = np.concatenate(cands)
            score = (self._log_kde(allc, good, bw_good) -
                     self._log_kde(allc, bad, bw_bad)).reshape(k, self.n_ei)
            return [self._snap(cands[i][int(np.argmax(score[i]))])
                    for i in range(k)]
        lie = {"min": min(self.ys), "mean": float(np.mean(self.ys)),
               "max": max(self.ys)}[liar]
        real_xs, real_ys = self.xs, self.ys
        n_real = len(real_xs)
        out: List[np.ndarray] = []
        try:
            self.xs, self.ys = list(real_xs), list(real_ys)
            for i in range(k):
                # startup is judged on REAL observations at batch entry so
                # a pre-startup batch stays all-uniform exactly like the
                # legacy mode (same RNG consumption per member)
                if n_real < self.n_startup:
                    x = self._snap(self._rng.uniform(self.lo, self.hi))
                else:
                    x = self._snap(self._propose(self._fit()))
                out.append(x)
                if i + 1 < k:
                    self.xs.append(np.asarray(x, float))
                    self.ys.append(lie)
        finally:
            self.xs, self.ys = real_xs, real_ys
        return out

    def tell(self, x: np.ndarray, y: float) -> None:
        self.xs.append(np.asarray(x, float))
        self.ys.append(float(y))

    def tell_batch(self, xs: Sequence[np.ndarray],
                   ys: Sequence[float]) -> None:
        """Record a batch of observations in proposal order (so a fixed-seed
        batched run replays the serial trial sequence)."""
        if len(xs) != len(ys):
            raise ValueError(f"got {len(xs)} proposals but {len(ys)} scores")
        for x, y in zip(xs, ys):
            self.tell(x, y)

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmax(self.ys))
        return self.xs[i], self.ys[i]

    # -------------------------------------------------------------- #
    def _bw(self, pts: np.ndarray) -> np.ndarray:
        """Per-point, per-dim bandwidths = distance to the neighbouring
        observation in that dim (hyperopt's adaptive Parzen): wide while the
        good set is spread out (exploration), tight once it clusters
        (refinement). A pure Scott bandwidth collapses onto the incumbent and
        the search stalls at random-search quality. All dims are sorted in
        one argsort call — this sits on the per-ask hot path."""
        span = self.hi - self.lo
        m = len(pts)
        order = np.argsort(pts, axis=0, kind="stable")        # (m, D)
        v = np.empty((m + 2, self.dim))
        v[0] = self.lo
        v[-1] = self.hi
        v[1:-1] = np.take_along_axis(pts, order, axis=0)
        bw_sorted = np.maximum(v[1:-1] - v[:-2], v[2:] - v[1:-1])
        bws = np.empty((m, self.dim))
        np.put_along_axis(bws, order, bw_sorted, axis=0)
        return np.clip(bws, 0.02 * span, 0.7 * span)

    def _sample_parzen(self, pts: np.ndarray, bw: np.ndarray,
                       n: int) -> np.ndarray:
        idx = self._rng.integers(len(pts), size=n)
        samp = pts[idx] + self._rng.normal(size=(n, self.dim)) * bw[idx]
        # uniform-prior component: 20% of candidates explore globally
        n_prior = max(1, n // 5)
        samp[:n_prior] = self._rng.uniform(self.lo, self.hi,
                                           size=(n_prior, self.dim))
        return np.clip(samp, self.lo, self.hi)

    def _log_kde(self, x: np.ndarray, pts: np.ndarray,
                 bw: np.ndarray) -> np.ndarray:
        log_comp = -0.5 * _sq_dist_sums(x, pts, bw) - \
            np.sum(np.log(bw), axis=-1)[None]
        m = log_comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(log_comp - m).sum(axis=1))) - \
            np.log(len(pts))
