"""Span tracing and counters (DESIGN.md §18).

The process-global tracer defaults to ``NULL_TRACER``, whose ``enabled``
attribute is ``False`` and whose ``span`` hands out one shared no-op
context manager — instrumented code guards every other emission behind
``if tr.enabled`` (or never branches at all: the serial search loop keeps
its uninstrumented hot loop verbatim when tracing is off), so the
disabled path pays an attribute check or a no-op ``with`` and stays
IEEE-bit-identical to the pre-telemetry build. Instrumentation only *reads* clocks and counters; it
never touches a float any engine computes, so the enabled path is
bit-identical too (gated in ``benchmarks_torch/obs_bench.py``).

Every finished span carries an ``id`` and its opener's id (``parent``,
``None`` at a root) beside its ``depth``. While a ``torch.profiler``
session records, a span opened with ``Tracer.span`` is also a host range
of the profile, ``obs:<name>``, entered and left with the span: the two
share the profiler's clock, so a span lies on the device trace. With no
profiler a span reads the clock twice and nothing else.

The clock is injectable (``Tracer(clock=...)``) so tests run on fake time.
``to_chrome_trace``/``export_chrome_trace`` emit Chrome trace-event JSON
(``{"traceEvents": [...]}`` with "X" complete events — loadable in
Perfetto / ``chrome://tracing``); ``id`` and ``parent`` ride in ``args``.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

#: prefix of a span's range in a ``torch.profiler`` profile
PROFILE_PREFIX = "obs:"


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

    def add_span(self, name: str, t0: float, t1: float,
                 depth: Optional[int] = None, **args) -> None:
        pass

    def count(self, name: str, n: float = 1) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """An open span: records its end time and pops itself off the tracer's
    stack on ``__exit__``. Exceptions propagate (the span still closes).
    ``args`` may be added to while the span is open."""

    __slots__ = ("_tr", "name", "t0", "depth", "args", "id", "parent",
                 "_range")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        tr = self._tr
        stack = tr._stack
        self.depth = len(stack)
        self.parent = stack[-1].id if stack else None
        self.id = tr._new_id()
        stack.append(self)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            # PyTorch's lightweight ``record_function``. On an H100's host
            # (torch 2.11, ``tools/search_spans_torch.py``'s
            # ``span_cost_us``) a bare range costs 1.3-1.9 us and lasts
            # 9-20 us longer in the profile than the work inside it; the
            # public ``record_function`` costs 7.9-13.8 us and its range
            # lasts 77-144 us longer, which would blur spans of ~0.1 ms
            self._range = torch._C._profiler._RecordFunctionFast(
                PROFILE_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = tr.now()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        t1 = tr.now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tr._stack.pop()
        tr._record(self.name, self.t0, t1, self.depth, self.args, self.id,
                   self.parent)
        return False


class Tracer:
    """Collects nested spans and counters in-process.

    * ``span(name, **args)`` — context manager; nesting depth and parent
      come from the tracer's open-span stack, start/end from its clock.
    * ``add_span(name, t0, t1, depth=None, **args)`` — record a span
      whose times the caller already measured; its parent is the
      innermost open span, and so is its depth unless given. It appears
      in no profile.
    * ``count(name, n)`` — monotonic counters. ``instant(name, **args)``
      records a zero-duration marker event.

    Timestamps are whatever the injected ``clock`` returns (seconds by
    default); the Chrome exporter scales to microseconds.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.events: List[dict] = []     # finished spans + instants
        self._stack: List[_Span] = []
        self._ids = 0
        self.counters: Dict[str, float] = {}

    # ----------------------------------------------------------------- #
    def now(self) -> float:
        return self._clock()

    def _new_id(self) -> int:
        self._ids += 1
        return self._ids

    def _open_id(self) -> Optional[int]:
        return self._stack[-1].id if self._stack else None

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def add_span(self, name: str, t0: float, t1: float,
                 depth: Optional[int] = None, **args) -> None:
        self._record(name, t0, t1,
                     len(self._stack) if depth is None else depth, args,
                     self._new_id(), self._open_id())

    def _record(self, name: str, t0: float, t1: float, depth: int,
                args: dict, id: int, parent: Optional[int]) -> None:
        self.events.append({"name": name, "t0": t0, "t1": t1,
                            "depth": depth, "args": args, "id": id,
                            "parent": parent})

    def instant(self, name: str, **args) -> None:
        t = self.now()
        self._record(name, t, t, len(self._stack), args, self._new_id(),
                     self._open_id())

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    # ----------------------------------------------------------------- #
    def to_chrome_trace(self, pid: int = 0, tid: int = 0) -> dict:
        """Chrome trace-event JSON: one "X" (complete) event per finished
        span and marker, ``ts``/``dur`` in microseconds as the format
        requires, the span's ``id`` and ``parent`` in ``args``. Loadable
        in Perfetto."""
        out = []
        for e in self.events:
            ts = e["t0"] * 1e6
            dur = (e["t1"] - e["t0"]) * 1e6
            out.append({"name": e["name"], "ph": "X", "ts": ts, "dur": dur,
                        "pid": pid, "tid": tid,
                        "args": {**e["args"], "id": e["id"],
                                 "parent": e["parent"]}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str, pid: int = 0,
                            tid: int = 0) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid=pid, tid=tid), f, indent=1,
                      sort_keys=True)
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
