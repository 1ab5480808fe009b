"""Seeded request-trace generators for the deployment simulator.

A ``Trace`` is the offered load of a serving deployment: request arrival
times (in accelerator cycles — the unit the whole perf model speaks) plus
a per-request *size* in samples (tokens for LM stacks, images for CNNs).
Generators cover the standard traffic shapes:

  * ``poisson_trace``  — memoryless steady traffic;
  * ``mmpp_trace``     — bursty: a two-state Markov-modulated Poisson
    process alternating a base rate and a burst rate with exponential
    dwell times;
  * ``diurnal_trace``  — a smooth peak/trough ramp (nonhomogeneous Poisson
    by thinning), one period = one "day";
  * ``replay_trace``   — replay recorded arrival/size arrays.

Every generator is deterministic in ``seed``. Per-request sizes follow the
serving stack's batch-shape discipline: ``bucket_sizes`` pads raw sizes up
to the nearest compiled bucket — the same pad-up rule
``CNNEvaluator.evaluate_batch`` applies to ragged proposal batches
(DESIGN.md §8), so simulated service is charged on the shapes an executor
would actually run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np

SizeSpec = Union[int, Sequence[int], tuple]


@dataclass
class Trace:
    """A request stream: ``arrivals`` (cycles, nondecreasing) + ``sizes``
    (samples per request). ``kind`` tags the generator for reports."""
    arrivals: np.ndarray
    sizes: np.ndarray
    kind: str = "replay"

    def __post_init__(self):
        self.arrivals = np.asarray(self.arrivals, dtype=np.float64)
        self.sizes = np.asarray(self.sizes, dtype=np.int64)
        if self.sizes.shape != self.arrivals.shape:
            raise ValueError("arrivals and sizes must have equal length")
        if len(self.arrivals) and np.any(np.diff(self.arrivals) < 0):
            raise ValueError("arrivals must be nondecreasing")
        if np.any(self.sizes < 1):
            raise ValueError("request sizes must be >= 1 sample")

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def total_samples(self) -> int:
        return int(self.sizes.sum())

    @property
    def span(self) -> float:
        """Cycles from the first to the last arrival."""
        return float(self.arrivals[-1] - self.arrivals[0]) if len(self) \
            else 0.0

    @property
    def offered_load(self) -> float:
        """Mean offered samples/cycle over the arrival span (inf for a
        backlogged trace whose arrivals coincide)."""
        return self.total_samples / self.span if self.span > 0 \
            else float("inf")

    def bucketize(self, buckets: Sequence[int]) -> "Trace":
        """Pad every request size up to its serving bucket (see
        ``bucket_sizes``)."""
        return Trace(self.arrivals.copy(), bucket_sizes(self.sizes, buckets),
                     kind=self.kind)

    def scaled(self, load_factor: float) -> "Trace":
        """The same request sequence offered ``load_factor`` x as fast
        (arrival axis compressed; sizes untouched)."""
        if load_factor <= 0:
            raise ValueError("load_factor must be positive")
        return Trace(self.arrivals / load_factor, self.sizes.copy(),
                     kind=self.kind)


def _draw_sizes(rng: np.random.Generator, n: int, sizes: SizeSpec) -> np.ndarray:
    """Size spec -> (n,) int64: a constant, a uniform choice over shapes,
    or a ``(shapes, probs)`` weighted choice."""
    if isinstance(sizes, (int, np.integer)):
        return np.full(n, int(sizes), dtype=np.int64)
    if (isinstance(sizes, tuple) and len(sizes) == 2
            and not isinstance(sizes[0], (int, np.integer))
            and len(sizes[0]) == len(sizes[1])):
        shapes, probs = sizes
        probs = np.asarray(probs, dtype=np.float64)
        return rng.choice(np.asarray(shapes, dtype=np.int64), size=n,
                          p=probs / probs.sum())
    return rng.choice(np.asarray(list(sizes), dtype=np.int64), size=n)


def bucket_sizes(sizes: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Pad each size up to the smallest bucket that holds it — the
    evaluator's batch-shape rule (a ragged batch pads up to an
    already-compiled shape; DESIGN.md §8). Sizes above the largest bucket
    are served as whole chunks of the largest bucket."""
    b = np.sort(np.asarray(list(buckets), dtype=np.int64))
    if len(b) == 0 or b[0] < 1:
        raise ValueError("buckets must be a nonempty list of sizes >= 1")
    s = np.asarray(sizes, dtype=np.int64)
    idx = np.searchsorted(b, s, side="left")
    out = b[np.minimum(idx, len(b) - 1)]
    over = idx >= len(b)
    out = np.where(over, -(-s // b[-1]) * b[-1], out)
    return out.astype(np.int64)


def request_rate(steady_throughput: float, utilization: float,
                 mean_size: float) -> float:
    """Requests/cycle that offer ``utilization`` of a deployment's steady
    sample rate with ``mean_size`` samples per request."""
    return utilization * steady_throughput / mean_size


def replay_trace(arrivals: Sequence[float], sizes: SizeSpec = 1) -> Trace:
    """Replay recorded arrivals; scalar ``sizes`` broadcasts."""
    arr = np.asarray(arrivals, dtype=np.float64)
    if isinstance(sizes, (int, np.integer)):
        sz = np.full(len(arr), int(sizes), dtype=np.int64)
    else:
        sz = np.asarray(list(sizes), dtype=np.int64)
    return Trace(arr, sz, kind="replay")


def backlogged_trace(n: int, size: int) -> Trace:
    """All requests queued at t=0 — the saturation-measurement workload."""
    return Trace(np.zeros(n), np.full(n, int(size), dtype=np.int64),
                 kind="backlogged")


def poisson_trace(n: int, rate: float, *, sizes: SizeSpec = 1,
                  seed: int = 0) -> Trace:
    """Memoryless arrivals at ``rate`` requests/cycle."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return Trace(arr, _draw_sizes(rng, n, sizes), kind="poisson")


def mmpp_trace(n: int, rate_base: float, rate_burst: float, *,
               dwell_base: float, dwell_burst: float,
               sizes: SizeSpec = 1, seed: int = 0) -> Trace:
    """Two-state Markov-modulated Poisson process: exponential dwell in a
    base state (``rate_base``) and a burst state (``rate_burst``), the
    standard bursty-traffic model. Dwells are mean cycles per visit."""
    if min(rate_base, rate_burst) <= 0 or min(dwell_base, dwell_burst) <= 0:
        raise ValueError("rates and dwells must be positive")
    rng = np.random.default_rng(seed)
    arr = np.empty(n, dtype=np.float64)
    t = 0.0
    burst = False
    t_switch = rng.exponential(dwell_base)
    k = 0
    while k < n:
        rate = rate_burst if burst else rate_base
        nxt = t + rng.exponential(1.0 / rate)
        if nxt >= t_switch:
            # no arrival before the state flips; restart the clock there
            # (exponential interarrivals are memoryless)
            t = t_switch
            burst = not burst
            t_switch = t + rng.exponential(dwell_burst if burst
                                           else dwell_base)
            continue
        t = nxt
        arr[k] = t
        k += 1
    return Trace(arr, _draw_sizes(rng, n, sizes), kind="mmpp")


def diurnal_trace(n: int, rate_trough: float, rate_peak: float,
                  period: float, *, sizes: SizeSpec = 1,
                  seed: int = 0) -> Trace:
    """Smooth diurnal ramp: a nonhomogeneous Poisson process whose rate
    swings sinusoidally between trough and peak once per ``period`` cycles
    (generated by thinning against the peak rate)."""
    if not (0 < rate_trough <= rate_peak) or period <= 0:
        raise ValueError("need 0 < rate_trough <= rate_peak and period > 0")
    rng = np.random.default_rng(seed)
    arr = np.empty(n, dtype=np.float64)
    t = 0.0
    k = 0
    while k < n:
        t += rng.exponential(1.0 / rate_peak)
        rate = rate_trough + (rate_peak - rate_trough) * \
            0.5 * (1.0 - np.cos(2.0 * np.pi * t / period))
        if rng.uniform() * rate_peak <= rate:
            arr[k] = t
            k += 1
    return Trace(arr, _draw_sizes(rng, n, sizes), kind="diurnal")
