"""Tiny level-filtered logger routed through the obs layer (DESIGN.md §18).

Replaces ad-hoc ``print()`` calls (``repro_torch.launch.dryrun``): each logger
prefixes its name (``[dryrun] ...`` message text preserved), filters by
level, and writes through a swappable ``sink`` so tests capture output
without touching stdout. When a real tracer is installed, every emitted
line also bumps a ``log.<name>.<level>`` counter and records an instant
event — log volume shows up in the same trace as the spans.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from repro_torch.obs.trace import get_tracer

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


class Logger:
    """Level-filtered, sink-swappable logger. ``sink`` is any
    ``callable(str)`` (``None`` = ``print``)."""

    def __init__(self, name: str, level: str = "info",
                 sink: Optional[Callable[[str], None]] = None):
        self.name = name
        self.level = level
        self.sink = sink

    def log(self, level: str, msg: str) -> None:
        if LEVELS[level] < LEVELS[self.level]:
            return
        line = f"[{self.name}] {msg}"
        (self.sink or print)(line)
        tr = get_tracer()
        if tr.enabled:
            tr.count(f"log.{self.name}.{level}")
            tr.instant(f"log.{self.name}", level=level, msg=msg)

    def debug(self, msg: str) -> None:
        self.log("debug", msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", msg)

    def error(self, msg: str) -> None:
        self.log("error", msg)


_LOGGERS: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    """Shared per-name logger registry, so a test can retarget the sink of
    the logger production code already holds."""
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = _LOGGERS[name] = Logger(name)
    return lg


@contextmanager
def capture(name: str):
    """Collect a named logger's lines for the duration of a block."""
    lines: List[str] = []
    lg = get_logger(name)
    old = lg.sink
    lg.sink = lines.append
    try:
        yield lines
    finally:
        lg.sink = old
