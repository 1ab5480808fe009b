"""Search flight recorder (DESIGN.md §18): one JSONL record per trial.

``hass_search`` / ``autoscale_policy_search`` / ``slo_partition_search``
take ``recorder=FlightRecorder(path)`` and emit

  * one **header** record — search kind, schema version, config;
  * one **trial** record per trial — proposal ``x``, score, metric terms,
    DSECache counter deltas (hit / warm_l1 / warm_l2 / cold_runs), engine
    dispatch deltas (flat / grouped / compiled / lockstep), and per-phase
    wall seconds (propose / evaluate / tell);
  * one **footer** record — trial count, best score, total wall seconds,
    and aggregate totals that equal the SUM of the per-trial deltas
    (round-trip-tested). Proposal-batched rounds attribute the round's
    shared work (phases, counter deltas) to the round's FIRST trial and
    zeros to the rest — each record carries ``round_size`` — so the sum
    convention holds there too.

Records are plain ``json`` lines; non-finite floats serialize as the
``json`` module's ``Infinity``/``NaN`` tokens, which round-trip through
``read_records`` (same library both ways). ``tools/trace_report.py``
summarizes and diffs recorded runs.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1


def _jsonable(v):
    """Best-effort conversion of numpy scalars/arrays for ``json``."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class FlightRecorder:
    """Writes one search run to ``path`` as JSONL. The clock is injectable
    (fake-time tests); aggregate totals accumulate per-trial in write
    order, so the footer equals the left-to-right sum of the trial
    records bit-for-bit."""

    def __init__(self, path: str,
                 clock=time.perf_counter):
        self.path = path
        self._f = open(path, "w")
        self._clock = clock
        self._t0: Optional[float] = None
        self.n_trials = 0
        self._best = float("-inf")
        self._cache_tot: Dict[str, float] = {}
        self._engine_tot: Dict[str, float] = {}
        self._phase_tot: Dict[str, float] = {}
        self._closed = False

    # ----------------------------------------------------------------- #
    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")

    def header(self, search: str, **config) -> None:
        self._t0 = self._clock()
        self._write({"record": "header", "schema": SCHEMA_VERSION,
                     "search": search, "config": _jsonable(config)})

    def trial(self, index: int, x, score: float, metrics: dict, *,
              cache: Optional[dict] = None, engine: Optional[dict] = None,
              phases: Optional[dict] = None, **extra) -> None:
        cache = {} if cache is None else cache
        engine = {} if engine is None else engine
        phases = {} if phases is None else phases
        for tot, d in ((self._cache_tot, cache),
                       (self._engine_tot, engine),
                       (self._phase_tot, phases)):
            for k, v in d.items():
                tot[k] = tot.get(k, 0) + v
        self.n_trials += 1
        if score > self._best:
            self._best = score
        self._write({"record": "trial", "i": int(index),
                     "x": _jsonable(x), "score": _jsonable(score),
                     "metrics": _jsonable(metrics),
                     "cache": _jsonable(cache), "engine": _jsonable(engine),
                     "phases": _jsonable(phases),
                     **{k: _jsonable(v) for k, v in extra.items()}})

    def footer(self, **extra) -> None:
        wall = (self._clock() - self._t0) if self._t0 is not None else 0.0
        self._write({"record": "footer", "n_trials": self.n_trials,
                     "best_score": _jsonable(self._best),
                     "wall_s": wall,
                     "totals": {"cache": dict(self._cache_tot),
                                "engine": dict(self._engine_tot),
                                "phases": dict(self._phase_tot)},
                     **{k: _jsonable(v) for k, v in extra.items()}})
        self._f.flush()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._f.close()

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# --------------------------------------------------------------------- #
def read_records(path: str) -> List[dict]:
    """Every JSONL record of one recorded run, in write order."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_run(path: str) -> dict:
    """One recorded run as ``{"header": ..., "trials": [...],
    "footer": ...}`` (header/footer ``None`` when absent — e.g. a run
    killed mid-flight still loads its trials)."""
    header = footer = None
    trials: List[dict] = []
    for rec in read_records(path):
        kind = rec.get("record")
        if kind == "header":
            header = rec
        elif kind == "footer":
            footer = rec
        elif kind == "trial":
            trials.append(rec)
    return {"header": header, "trials": trials, "footer": footer}
