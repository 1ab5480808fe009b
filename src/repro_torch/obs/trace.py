"""Span tracing, counters, gauges, and histograms (DESIGN.md §18).

The process-global tracer defaults to ``NULL_TRACER``, whose ``enabled``
attribute is ``False`` — instrumented code guards every emission behind
``if tr.enabled`` (or never branches at all: the search loop keeps its
uninstrumented hot loop verbatim when tracing is off), so the disabled
path pays one attribute check and stays IEEE-bit-identical to the
pre-telemetry build. Instrumentation only *reads* clocks and counters; it
never touches a float any engine computes, so the enabled path is
bit-identical too (gated in ``benchmarks/obs_bench.py``).

The clock is injectable (``Tracer(clock=...)``) so tests run on fake time.
Exporters: ``to_chrome_trace``/``export_chrome_trace`` emit Chrome
trace-event JSON (``{"traceEvents": [...]}`` with "X" complete events —
loadable in Perfetto / ``chrome://tracing``); ``metrics``/
``export_metrics`` emit one flat JSON of counters, gauges, and histogram
summaries.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional


class Counters:
    """A named-counter bag: plain dict-backed integer counters with
    snapshot/delta support. Backs ``DSECache.stats()`` and any other
    always-on counter set — increments are one dict store, cheap enough
    to leave unguarded on decision paths that already cost an array
    compare."""

    __slots__ = ("_c",)

    def __init__(self, *names: str):
        self._c: Dict[str, int] = {n: 0 for n in names}

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def set(self, name: str, value: int) -> None:
        self._c[name] = value

    def as_dict(self) -> Dict[str, int]:
        return dict(self._c)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._c)

    def delta_since(self, snap: Dict[str, int]) -> Dict[str, int]:
        return {k: v - snap.get(k, 0) for k, v in self._c.items()}


class _NullSpan:
    """Shared no-op context manager handed out by ``NullTracer.span`` —
    one singleton, so the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The process-global default: every method is a no-op and ``enabled``
    is ``False``, so instrumented code pays one attribute check."""

    enabled = False

    def now(self) -> float:
        return time.perf_counter()

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float, depth: int = 0,
                 **args) -> None:
        pass

    def count(self, name: str, n: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """An open span: records its end time and pops itself off the tracer's
    stack on ``__exit__``. Exceptions propagate (the span still closes)."""

    __slots__ = ("_tr", "name", "t0", "depth", "args")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self.depth = len(self._tr._stack)
        self._tr._stack.append(self)
        self.t0 = self._tr.now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tr.now()
        self._tr._stack.pop()
        self._tr._finish(self.name, self.t0, t1, self.depth, self.args)
        return False


class Tracer:
    """Collects nested spans, counters, gauges, and histograms in-process.

    * ``span(name, **args)`` — context manager; nesting depth comes from
      the tracer's open-span stack, start/end from its clock.
    * ``add_span(name, t0, t1, depth=0, **args)`` — record a span whose
      times the caller already measured (the search loop reads the clock
      inline so its per-trial overhead is four clock reads, not four
      context-manager frames).
    * ``count(name, n)`` / ``gauge(name, v)`` / ``observe(name, v)`` —
      monotonic counters, last-value gauges, and min/max/sum/count
      histogram summaries. ``instant(name, **args)`` records a
      zero-duration marker event.

    Timestamps are whatever the injected ``clock`` returns (seconds by
    default); the Chrome exporter scales to microseconds.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.events: List[dict] = []     # finished spans + instants
        self._stack: List[_Span] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Dict[str, float]] = {}

    # ----------------------------------------------------------------- #
    def now(self) -> float:
        return self._clock()

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def add_span(self, name: str, t0: float, t1: float, depth: int = 0,
                 **args) -> None:
        self._finish(name, t0, t1, depth, args)

    def _finish(self, name: str, t0: float, t1: float, depth: int,
                args: dict) -> None:
        self.events.append({"name": name, "t0": t0, "t1": t1,
                            "depth": depth, "args": args})

    def instant(self, name: str, **args) -> None:
        t = self.now()
        self.events.append({"name": name, "t0": t, "t1": t,
                            "depth": len(self._stack), "args": args})

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            self.hists[name] = {"count": 1, "sum": value,
                                "min": value, "max": value}
        else:
            h["count"] += 1
            h["sum"] += value
            if value < h["min"]:
                h["min"] = value
            if value > h["max"]:
                h["max"] = value

    # ----------------------------------------------------------------- #
    def to_chrome_trace(self, pid: int = 0, tid: int = 0) -> dict:
        """Chrome trace-event JSON: one "X" (complete) event per finished
        span, "i" (instant) for zero-duration markers; ``ts``/``dur`` in
        microseconds as the format requires. Loadable in Perfetto."""
        out = []
        for e in self.events:
            ts = e["t0"] * 1e6
            dur = (e["t1"] - e["t0"]) * 1e6
            ev = {"name": e["name"], "ph": "X", "ts": ts, "dur": dur,
                  "pid": pid, "tid": tid}
            if e["args"]:
                ev["args"] = dict(e["args"])
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str, pid: int = 0,
                            tid: int = 0) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid=pid, tid=tid), f, indent=1,
                      sort_keys=True)
        return path

    def metrics(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: dict(v) for k, v in self.hists.items()}}

    def export_metrics(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.metrics(), f, indent=1, sort_keys=True)
        return path


# --------------------------------------------------------------------- #
# process-global tracer
# --------------------------------------------------------------------- #
_TRACER = NULL_TRACER


def get_tracer():
    """The process-global tracer (``NULL_TRACER`` unless installed)."""
    return _TRACER


def set_tracer(tracer) -> object:
    """Install ``tracer`` (or ``None`` for the no-op default) process-wide;
    returns the previous tracer so callers can restore it."""
    global _TRACER
    prev = _TRACER
    _TRACER = NULL_TRACER if tracer is None else tracer
    return prev


@contextmanager
def use_tracer(tracer):
    """Install ``tracer`` for the duration of a ``with`` block."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
