"""The benchmark of the port: back-to-back hardware-aware HASS searches on
one evaluator, as a designer's session runs them.

A run has three parts.

1. Set-up (``setup_s``, from process start to the first timed round): the
   CUDA kernels and the DSE's C kernel loaded from their build caches in
   the checkout, the weights and calibration images made on the device from
   the seed (``inputs``), the ``CNNEvaluator`` built, and one short warm-up
   search that captures the cell's batch shape.
2. The window: ``hass_search`` calls of the traffic's trial count, each
   with its own seed, until ``--seconds`` have passed. The evaluator and its
   DSE cache carry over from search to search. ``Probe`` stands between the
   search and the evaluator: it stamps each round (one ``evaluate_batch``,
   or one ``__call__`` in a serial search) and keeps what the timed path
   returned. The round that starts after the window's end is not run.
3. The check: a sample of the window's proposals, drawn from the seed, is
   measured again by the plain reference (``hassbench/reference``) and
   compared (``reference.compare``) against what the program returned.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the cell's check: sample size and limits) and
``metrics/<metric>.py`` (a reader of one per-layer metric).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hassbench import inputs, yardstick
from hassbench.reference import compare
from hassbench.reference.forward import Reference
from hassbench.reference.hardware import Hardware
from hassbench.reference.layers import load as load_layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names the process that prints a result may not hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: searches after the profiled first that write a recorder file in a
#: traced run; the later ones run as in an untraced run
RECORDED_SEARCHES = 8


class WindowClosed(Exception):
    """Raised by ``Probe`` at the first round that would start after the
    window's end."""


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its configuration,
    traffic and check files, and the metrics that it reports."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "hassbench")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=read_json(os.path.join(root, conf["file"])),
        traffic=read_json(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")),
        check=read_json(os.path.join(here, "workloads", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The module of the per-layer metric ``name``
    (``hassbench/metrics/<name>.py``)."""
    return importlib.import_module(f"hassbench.metrics.{name}")


# --------------------------------------------------------------------- #
# the probe between the search and the evaluator
# --------------------------------------------------------------------- #
@dataclass
class Round:
    xs: List[np.ndarray]
    acc: np.ndarray
    s_w: np.ndarray
    s_a: np.ndarray
    metrics: List[dict]
    search: int = 0


class Probe:
    """Hands ``hass_search`` the evaluator: attribute reads and writes go
    through to it (the search sets ``lambdas``), each round is stamped,
    and in the window each round's proposals, the rows of its device pass
    (read where ``CNNEvaluator._pass`` returns them) and its metrics are
    kept. ``labels`` marks the evaluator's calls for the profiler;
    ``search`` is the index of the window's search under way."""

    _OWN = ("_ev", "_rows", "clock", "deadline", "recording", "stamps",
            "rounds", "closed_at", "labels", "search")

    def __init__(self, ev, clock: Callable[[], float] = time.perf_counter):
        object.__setattr__(self, "_ev", ev)
        for k, v in (("_rows", None), ("clock", clock),
                     ("deadline", math.inf), ("recording", False),
                     ("stamps", []), ("rounds", []), ("closed_at", None),
                     ("labels", False), ("search", 0)):
            object.__setattr__(self, k, v)
        inner = ev._pass

        def _pass(s_w, s_a, codes, n_real):
            with self._label("hassbench.pass"):
                out = inner(s_w, s_a, codes, n_real)
            object.__setattr__(self, "_rows", out)
            return out
        ev._pass = _pass

    def __getattr__(self, name):
        return getattr(self._ev, name)

    def __setattr__(self, name, value):
        if name in Probe._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._ev, name, value)

    def _label(self, name: str):
        if self.labels:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def open_window(self, seconds: float) -> float:
        t0 = self.clock()
        self.deadline = t0 + seconds
        self.recording = True
        return t0

    def _round(self, xs, call):
        if self.recording:
            t = self.clock()
            if t >= self.deadline:
                self.closed_at = t
                raise WindowClosed
            self.stamps.append(t)
        with self._label("hassbench.evaluate"):
            ms = call()
        if self.recording:
            acc, s_w, s_a, _ = self._rows
            n = len(xs)
            self.rounds.append(Round(
                [np.asarray(x) for x in xs], np.array(acc[:n]),
                np.array(s_w[:n]), np.array(s_a[:n]), [dict(m) for m in ms],
                self.search))
        return ms

    def evaluate_batch(self, xs):
        return self._round(xs, lambda: self._ev.evaluate_batch(xs))

    def __call__(self, x):
        return self._round([x], lambda: [self._ev(x)])[0]


# --------------------------------------------------------------------- #
# set-up, window, check
# --------------------------------------------------------------------- #
@dataclass
class Session:
    cell: Cell
    seed: int
    device: torch.device
    layers: list
    params: dict
    images: torch.Tensor
    ev: object
    probe: Probe
    n_prunable: int


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def search_kwargs(cell: Cell, seed: int, k: int) -> dict:
    """``hass_search`` arguments of search ``k`` of a run (``k`` = -1: the
    warm-up search)."""
    t = cell.traffic
    return dict(iters=t["trials"] if k >= 0 else t["warmup_trials"],
                hardware_aware=t["hardware_aware"],
                batch_size=t["batch_size"], liar=t["liar"],
                seed=inputs.sub_seed(seed, 2, k + 1))


def setup(cell: Cell, seed: int, device="cuda", img_res: Optional[int] = None
          ) -> Session:
    """Everything before the window: the built kernels, the inputs from
    the seed, the evaluator, the warm-up search."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import _dse_ckernel
    from repro_torch.core.hass import CNNEvaluator, hass_search
    from repro_torch.core.perf_model import FPGAModel
    from repro_torch.kernels import build
    dev = torch.device(device)
    c = cell.config
    res = img_res or c["img_res"]
    if dev.type == "cuda":
        build.lib()
    _dse_ckernel.get_lib()
    layers = load_layers(c["arch"], res, c["num_classes"])
    params, images = inputs.make(layers, seed, c["calib_images"], res, dev)
    cfg = ModelConfig(name=c["name"], family="cnn", cnn_arch=c["arch"],
                      img_res=res, num_classes=c["num_classes"])
    ev = CNNEvaluator(cfg, params, images, FPGAModel(),
                      budget=c["dsp_budget"], dse_iters=c["dse_iters"],
                      cost_cfg=cfg)
    probe = Probe(ev)
    L = len(ev.prunable)
    hass_search(probe, L, **search_kwargs(cell, seed, -1))
    _sync(dev)
    # what set-up made stays alive all run: out of the collector's scans
    gc.collect()
    gc.freeze()
    return Session(cell, seed, dev, layers, params, images, ev, probe, L)


@dataclass
class Window:
    t0: float
    t_end: float
    searches: int
    rounds: List[Round]
    round_s: List[float]
    search_t0: List[float] = field(default_factory=list)
    #: the first search that neither the profiler nor a recorder touched
    untraced_from: int = 0
    recorder_files: List[str] = field(default_factory=list)
    profile: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    @property
    def trials(self) -> int:
        return sum(len(r.xs) for r in self.rounds)


def run_window(s: Session, seconds: float, trace: bool) -> Window:
    """Back-to-back searches for ``seconds``. With ``trace`` the first is
    profiled (``torch.profiler``) and it and the next
    ``RECORDED_SEARCHES`` write a ``FlightRecorder`` file each to the
    temporary directory."""
    from repro_torch.core.hass import hass_search
    from repro_torch.obs import FlightRecorder
    probe = s.probe
    files: List[str] = []
    # the profiler starts before the window opens (its first start takes
    # seconds on the card) and covers the window's first search
    prof = _start_profile(s.device) if trace else None
    probe.labels = prof is not None
    t0 = probe.open_window(seconds)
    if prof is not None:
        prof["t0"] = t0
    k = 0
    search_t0: List[float] = []
    try:
        while True:
            probe.search = k
            search_t0.append(probe.clock())
            rec = None
            if trace and k <= RECORDED_SEARCHES:
                fd, path = tempfile.mkstemp(prefix=f"hassbench-{k}-",
                                            suffix=".jsonl")
                os.close(fd)
                files.append(path)
                rec = FlightRecorder(path)
            try:
                hass_search(probe, s.n_prunable, recorder=rec,
                            **search_kwargs(s.cell, s.seed, k))
            finally:
                if rec is not None:
                    rec.close()
                if prof is not None and k == 0:
                    prof = _stop_profile(prof, s.device)
                    probe.labels = False
            k += 1
    except WindowClosed:
        pass
    t_end = probe.closed_at
    stamps = probe.stamps + [t_end]
    round_s = [b - a for a, b in zip(stamps, stamps[1:])]
    if round_s:
        round_s[0] += stamps[0] - t0
    probe.recording = False
    return Window(t0, t_end, k, list(probe.rounds), round_s, search_t0,
                  RECORDED_SEARCHES + 1 if trace else 0, files, prof)


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as e:           # the profiler cannot trace here
        print(f"profiler: {e}", file=sys.stderr)
        return None
    return {"prof": prof}


def _stop_profile(p: dict, dev: torch.device) -> dict:
    _sync(dev)
    p["wall_s"] = time.perf_counter() - p["t0"]
    p["prof"].stop()
    return p


def read_profile(p: Optional[dict]) -> Optional[dict]:
    """Device intervals, kernel times by name and idle gaps by what the
    host was doing, from a finished profile; ``None`` where the trace holds
    no device time."""
    if p is None:
        return None
    from torch.autograd import DeviceType
    dev_spans, by_name, labels = [], {}, []
    for e in p["prof"].events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("hassbench."):
            # the labels' ranges appear on the device's timeline too
            if e.device_type != DeviceType.CUDA:
                labels.append((a, b, e.name))
        elif e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            dev_spans.append((a, b))
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += b - a
            t[1] += 1
    if not dev_spans:
        return None
    lo = min(a for a, _ in dev_spans)
    hi = max(b for _, b in dev_spans)
    if labels:
        lo = min(lo, min(a for a, _, _ in labels))
        hi = max(hi, max(b for _, b, _ in labels))
    idle: Dict[str, float] = {}
    for a, b in yardstick.gaps(dev_spans, lo, hi):
        mid = (a + b) / 2
        # the innermost label over the gap: the device pass inside the
        # evaluator's call; outside any, the search loop (TPE ask and tell)
        inside = [(lb - la, name) for la, lb, name in labels
                  if la <= mid <= lb]
        what = min(inside)[1] if inside else "hassbench.search_loop"
        idle[what] = idle.get(what, 0.0) + (b - a)
    return {"busy_s": yardstick.busy(dev_spans), "wall_s": p["wall_s"],
            "kernels": by_name, "idle": idle}


def _sample(n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(inputs.sub_seed(seed, 3))
    return np.sort(rng.choice(n, size=min(n, k), replace=False))


def gather(w: Window, idx: np.ndarray):
    """(targets s_w, s_a (B, L), the program's rows, its metrics) of the
    window's proposals ``idx``, in window order."""
    xs, acc, sw, sa, ms = [], [], [], [], []
    for r in w.rounds:
        for j, x in enumerate(r.xs):
            xs.append(x)
            acc.append(r.acc[j])
            sw.append(r.s_w[j])
            sa.append(r.s_a[j])
            ms.append(r.metrics[j])
    L = len(sw[0])
    X = np.stack([xs[i] for i in idx]).astype(np.float64)
    t_w = X[:, :L].astype(np.float32)
    t_a = X[:, L:2 * L].astype(np.float32)
    prog = {"acc": np.array([acc[i] for i in idx]),
            "s_w": np.stack([sw[i] for i in idx]),
            "s_a": np.stack([sa[i] for i in idx])}
    return t_w, t_a, prog, [ms[i] for i in idx]


def answers(s: Session, w: Window, candidate: str = "program",
            sample: Optional[int] = None) -> dict:
    """The candidate's answers and the reference's over the same sampled
    proposals (the cell's ``sample`` of the window's, unless ``sample`` is
    given): the program's (``program``) as the timed path returned them,
    or the control's (``control``: the reference in TF32 and its DSE in
    float32, in the program's place)."""
    c = s.cell.config
    idx = _sample(w.trials, sample or s.cell.check["sample"], s.seed)
    t_w, t_a, prog, prog_hw = gather(w, idx)
    ref = Reference(s.layers, s.params, s.images, "float32")
    ref_dev = ref.evaluate(t_w, t_a)
    hw64 = Hardware(s.layers, c["dsp_budget"], c["dse_iters"], "float64")
    if candidate == "program":
        cand, cand_hw = prog, prog_hw
        cand["w_zeros"] = compare.counts(prog["s_w"], ref.w_numel)
        cand["a_zeros"] = compare.counts(prog["s_a"], ref.a_numel)
    elif candidate == "control":
        low = Reference(s.layers, s.params, s.images, "tf32")
        cand = low.evaluate(t_w, t_a)
        hw32 = Hardware(s.layers, c["dsp_budget"], c["dse_iters"], "float32")
        cand_hw = [hw32.metrics(cand["s_w"][i], cand["s_a"][i])
                   for i in range(len(idx))]
    else:
        raise ValueError(candidate)
    ref_hw = [hw64.metrics(cand["s_w"][i], cand["s_a"][i])
              for i in range(len(idx))]
    return {"cand": cand, "ref": ref_dev, "reference": ref,
            "dense_pred": ref.dense_pred.cpu().numpy(),
            "cand_hw": cand_hw, "ref_hw": ref_hw, "compared": len(idx)}


def check(s: Session, w: Window, candidate: str = "program",
          sample: Optional[int] = None) -> Dict[str, float]:
    """The numbers that decide ``correct`` (``reference.compare``) for the
    answers of ``answers(s, w, candidate, sample)``."""
    a = answers(s, w, candidate, sample)
    out = compare.numbers(a["cand"], a["ref"], a["dense_pred"],
                          a["cand_hw"], a["ref_hw"])
    out["compared"] = a["compared"]
    return out


# --------------------------------------------------------------------- #
# one run
# --------------------------------------------------------------------- #
@dataclass
class RunView:
    """What a per-layer metric's reader gets."""
    cell: Cell
    layers: list
    window: Window
    profile: Optional[dict]
    recorder_rounds: List[dict]


def _recorder_rounds(files: List[str]) -> List[dict]:
    """Each round's phases (seconds) from the searches' recorder files,
    leaving out the profiled first search where later ones exist."""
    from repro_torch.obs import read_records
    use = files[1:] if len(files) > 1 else files
    out = []
    for path in use:
        for rec in read_records(path):
            if rec.get("record") == "trial" and rec["phases"]["evaluate"] > 0:
                out.append(rec["phases"])
    return out


def end_to_end(name: str, w: Window, setup_s: float) -> float:
    if name == "trials_per_s":
        return w.trials / w.seconds
    if name == "round_ms_p95":
        return float(np.percentile(np.asarray(w.round_s) * 1e3, 95))
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def breakdown(prof: dict) -> dict:
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(prof["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, (s, _) in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def failed_trials(w: Window) -> int:
    """Trials whose metrics are not finite or out of their ranges."""
    bad = 0
    for r in w.rounds:
        for m in r.metrics:
            vals = [m.get(k, math.nan) for k in ("acc", "spa", "thr", "dsp")]
            if not all(math.isfinite(v) for v in vals) or \
                    not (0.0 <= m["acc"] <= 1.0 and 0.0 <= m["spa"] <= 1.0
                         and m["thr"] > 0.0):
                bad += 1
    return bad


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", img_res: Optional[int] = None) -> dict:
    """One run of ``cell``: the result object the last line prints."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    s = setup(cell, seed, device, img_res)
    setup_s = time.perf_counter() - t_start
    w = run_window(s, seconds, trace)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    prof = read_profile(w.profile)
    w.profile = None
    rec_rounds = _recorder_rounds(w.recorder_files)
    for path in w.recorder_files:
        os.remove(path)
    # the program's state goes before the reference runs; the inputs stay
    s.probe = s.ev = None
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(s, w)
    limits = cell.check["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    metrics: Dict[str, dict] = {}
    if trace:
        view = RunView(cell, s.layers, w, prof, rec_rounds)
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if prof is not None:
            device_info["busy_s"] = prof["busy_s"]
            device_info["window_s"] = prof["wall_s"]
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], w, setup_s),
                                  "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": w.trials,
           "failed": failed_trials(w), "metrics": metrics,
           "device": device_info}
    if trace and prof is not None:
        out["breakdown"] = breakdown(prof)
    out["compared"] = numbers["compared"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = find_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    out = run(cell, a.seed, a.seconds, bool(a.trace), t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
