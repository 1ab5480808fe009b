"""Where a benchmark cell's search round spends its time, by the program's
own spans: one run of a ``hassbench`` cell (set-up, then a traced window)
with a ``repro_torch.obs.Tracer`` installed.

* The device's idle gaps in the profiled first search, each instant
  under the innermost ``obs:`` range (the program's span) over it, per
  round (``idle_by_span``), rolled up beside the benchmark's own buckets
  (``harness.read_profile``'s ``idle``, by its ``hassbench.*`` labels),
  and held against them by the labels' rule (each gap whole, by its
  midpoint).
* The spans of the recorded searches after the profiled one (the
  searches whose recorder files give ``tpe_ask_ms`` / ``evaluate_ms``):
  each span's mean per round, ``evaluate`` split into ``evaluate.pass``,
  ``evaluate.dse`` and its own time, and the readings ``pass_wait_ms``
  (``pass.readback`` per round), ``pass_bubble_ms`` (device idle under
  ``obs:pass.readback`` in the profiled search, per ``obs:round``),
  ``dse_ms`` (``evaluate.dse`` per round) and ``dse_cold_share`` (cold
  runs over all ``DSECache`` decisions in the ``evaluate.dse`` spans).
* The tracer's counters over the window (``tpe.kde_native`` /
  ``tpe.kde_numpy``: which engine the TPE's KDE ran on;
  ``pass.clip_launches``: the batched clip kernel's launches;
  ``pass.conv_gemms``: the pass's convolutions that ran as one product;
  ``pass.conv_igemms``: the implicit-GEMM kernel's launches;
  ``pass.layer_norms``: the pass's LayerNorms; each also per
  ``evaluate.pass`` span).
* Every device operation of the profiled search by name, ms and calls a
  round (``device_ops_ms_per_round``).
* The set-up: the tracer is installed before ``harness.setup``, so the
  evaluator's ``evaluator.build`` span and its ``build.*`` children are
  read in ms (``setup_spans_ms``), beside the counters set-up left
  (``evaluator.act_sample_elems``: activations copied to the host for the
  clip thresholds' quantiles).
* What the spans cost: a span's enter and exit with and without a
  recording profiler, and a bare profile range by each of PyTorch's two
  mechanisms.

    python3 tools/search_spans_torch.py --workload resnet18.search.b8 \\
        --seed 7 [--seconds 15] [--out FILE]      # needs one CUDA device

Prints one JSON object (and writes it to ``--out``). A benchmark that
reads these metrics itself makes this tool redundant.
"""
import argparse
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

#: where a gap under no program span goes
NONE = "(none)"
#: spans under the evaluator's device pass
PASS_TREE = ("evaluate.pass", "pass.readback", "pass.build")
#: spans under the evaluator's call
EVALUATE_TREE = ("evaluate", "evaluate.dse") + PASS_TREE
#: the evaluator's set-up span and its children
BUILD_TREE = ("evaluator.build", "build.dense_forward", "build.act_samples",
              "build.dense_dse", "build.weight_sort")

Range = Tuple[float, float, str]


def innermost(t: float, ranges: Sequence[Range]) -> Optional[str]:
    """Name of the shortest range over ``t``, ``None`` under none."""
    inside = [(b - a, name) for a, b, name in ranges if a <= t <= b]
    return min(inside)[1] if inside else None


def idle_by_span(gaps: Iterable[Tuple[float, float]],
                 ranges: Sequence[Range], split: bool = True
                 ) -> Dict[str, float]:
    """Seconds of the device's idle ``gaps`` by the innermost range at
    each instant (``NONE``: under none): a gap that runs from one span
    into the next is split between them. ``split=False`` files each gap
    whole under the range over its midpoint, the rule of the benchmark's
    labels, to compare the spans with them."""
    cuts = sorted({t for a, b, _ in ranges for t in (a, b)}) if split \
        else []
    out: Dict[str, float] = {}
    for a, b in gaps:
        edges = [a] + [t for t in cuts if a < t < b] + [b]
        for u, v in zip(edges, edges[1:]):
            what = innermost((u + v) / 2, ranges) or NONE
            out[what] = out.get(what, 0.0) + (v - u)
    return out


def rollup(idle: Dict[str, float]) -> Dict[str, float]:
    """Idle seconds under the device pass (``evaluate.pass`` and its
    children), under the evaluator's call, and outside it."""
    in_pass = sum(v for k, v in idle.items() if k in PASS_TREE)
    in_eval = sum(v for k, v in idle.items() if k in EVALUATE_TREE)
    return {"pass": in_pass, "evaluate": in_eval,
            "outside_evaluate": sum(idle.values()) - in_eval,
            "none": idle.get(NONE, 0.0)}


def agrees(a: float, b: float, per_round: float = 1e-4) -> bool:
    """Within 5 % of the larger, or 0.1 ms a round (``a``, ``b`` per
    round in seconds), whichever is larger."""
    return abs(a - b) <= max(0.05 * max(abs(a), abs(b)), per_round)


def searches(events: Sequence[dict], first: int, last: int) -> List[dict]:
    """The spans of the window's searches ``first`` .. ``last`` (the
    tracer's ``search`` roots in order)."""
    roots = [e for e in events if e["name"] == "search"
             and e["parent"] is None]
    roots.sort(key=lambda e: e["t0"])
    keep = roots[first:last + 1]
    return [e for e in events
            if any(r["t0"] <= e["t0"] <= r["t1"] for r in keep)]


def span_readings(events: Sequence[dict]) -> Dict[str, object]:
    """Per-round means (ms) of each span and the four readings, over the
    spans of whole searches."""
    from repro_torch.core.hass import DSE_COUNTERS
    rounds = sum(e["name"] == "round" for e in events)
    if not rounds:
        return {}
    total: Dict[str, float] = {}
    for e in events:
        if e["name"] != "trial":
            total[e["name"]] = total.get(e["name"], 0.0) + e["t1"] - e["t0"]
    ms = {k: 1e3 * v / rounds for k, v in sorted(total.items())}
    dse = [e["args"] for e in events if e["name"] == "evaluate.dse"]
    decided = sum(a.get(k, 0) for a in dse for k in DSE_COUNTERS)
    return {
        "rounds": rounds,
        "ms_per_round": ms,
        "evaluate_split_ms": {
            "evaluate": ms.get("evaluate", 0.0),
            "evaluate.pass": ms.get("evaluate.pass", 0.0),
            "evaluate.dse": ms.get("evaluate.dse", 0.0),
            "evaluate_self": ms.get("evaluate", 0.0)
            - ms.get("evaluate.pass", 0.0) - ms.get("evaluate.dse", 0.0)},
        "dse_counters": {k: sum(a.get(k, 0) for a in dse)
                         for k in DSE_COUNTERS},
        "pass_wait_ms": ms.get("pass.readback", 0.0),
        "dse_ms": ms.get("evaluate.dse", 0.0),
        "dse_cold_share": 100.0 * sum(a.get("cold_runs", 0) for a in dse)
        / decided if decided else None,
    }


def setup_readings(events: Sequence[dict]) -> Dict[str, float]:
    """Milliseconds of each ``BUILD_TREE`` span the events hold, summed
    over the evaluators built, and ``evaluator.build``'s own time (what its
    children leave out)."""
    ms = {name: 1e3 * sum(e["t1"] - e["t0"] for e in events
                          if e["name"] == name)
          for name in BUILD_TREE if any(e["name"] == name for e in events)}
    if "evaluator.build" in ms:
        ms["evaluator.build_self"] = ms["evaluator.build"] - sum(
            v for k, v in ms.items() if k != "evaluator.build")
    return ms


def device_ops(kernels: Dict[str, list], rounds: int
               ) -> Dict[str, List[float]]:
    """Each device operation of the profiled search (its name cut to 120
    characters; names that agree that far are summed): [ms, calls] a
    round, the longest first."""
    ops: Dict[str, List[float]] = {}
    for name, (s, calls) in kernels.items():
        t = ops.setdefault(name[:120], [0.0, 0.0])
        t[0] += 1e3 * s / max(rounds, 1)
        t[1] += calls / max(rounds, 1)
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][0]))


def per_pass(counters: Dict[str, float], passes: int) -> Dict[str, float]:
    """The pass counters over the window's ``evaluate.pass`` spans:
    ``<name>_per_pass`` for each ``pass.<name>`` (a counter the window
    never touched reads 0); nothing without a pass."""
    if not passes:
        return {}
    return {f"{name}_per_pass": counters.get(f"pass.{name}", 0) / passes
            for name in ("clip_launches", "conv_gemms", "conv_igemms",
                         "layer_norms")}


def profile_readings(prof, label_idle: Dict[str, float]
                     ) -> Dict[str, object]:
    """The profiled search's device idle by the program's spans, over the
    device's work and the evaluator's calls (the interval the benchmark's
    labels span), beside ``label_idle``, the benchmark's idle seconds by
    its labels (``harness.read_profile(...)["idle"]``)."""
    from torch.autograd import DeviceType

    from hassbench import yardstick
    from repro_torch.obs.trace import PROFILE_PREFIX as PREFIX
    dev, obs_ranges = [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        on_device = e.device_type == DeviceType.CUDA
        if e.name.startswith(PREFIX):
            if not on_device:
                obs_ranges.append((a, b, e.name[len(PREFIX):]))
        elif on_device and not e.name.startswith("hassbench.") and \
                not getattr(e, "is_user_annotation", False):
            dev.append((a, b))
    if not dev:
        return {}
    calls = [(a, b) for a, b, name in obs_ranges if name == "evaluate"]
    lo = min(a for a, _ in dev + calls)
    hi = max(b for _, b in dev + calls)
    gaps = yardstick.gaps(dev, lo, hi)
    by_span = idle_by_span(gaps, obs_ranges)
    # the labels' rule, to hold the spans against the labels
    by_mid = rollup(idle_by_span(gaps, obs_ranges, split=False))
    counts: Dict[str, int] = {}
    for _, _, name in obs_ranges:
        counts[name] = counts.get(name, 0) + 1
    rounds = counts.get("round", 0)
    per = (lambda v: 1e3 * v / rounds) if rounds else (lambda v: None)
    roll = rollup(by_span)
    idle = sum(by_span.values())
    n = max(rounds, 1)
    return {
        "busy_s": yardstick.busy(dev), "interval_s": hi - lo,
        "idle_s": idle, "obs_rounds": rounds, "span_counts": counts,
        "idle_by_span_ms_per_round": {k: per(v) for k, v in
                                      sorted(by_span.items())},
        "idle_by_label_ms_per_round": {k: per(v) for k, v in
                                       sorted(label_idle.items())},
        "rollup_ms_per_round": {k: per(v) for k, v in roll.items()},
        "rollup_by_midpoint_ms_per_round": {k: per(v) for k, v in
                                            by_mid.items()},
        "none_share": roll["none"] / idle if idle else None,
        "pass_matches_label": agrees(
            by_mid["pass"] / n, label_idle.get("hassbench.pass", 0.0) / n),
        "outside_matches_label": agrees(
            by_mid["outside_evaluate"] / n,
            label_idle.get("hassbench.search_loop", 0.0) / n),
        "pass_bubble_ms": per(by_span.get("pass.readback", 0.0)),
    }


def span_cost_us(device, n: int = 20000, reps: int = 3
                 ) -> Dict[str, float]:
    """Microseconds of one span's enter and exit (one level under an open
    span), without a profiler and under one that records the host (and
    the card, on one); and under that profiler, a bare range entered and
    left by ``_RecordFunctionFast`` (what a span uses) and by the public
    ``record_function``, and how much longer each range lasts in the
    profile than the interval timed inside it (the most over 50 ranges
    of ~1 ms). The least of ``reps`` timings of each, in turns after a
    warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer

    def timed() -> float:
        tr = Tracer()
        with tr.span("outer"):
            t0 = time.perf_counter()
            for _ in range(n):
                with tr.span("x"):
                    pass
            return (time.perf_counter() - t0) / n * 1e6

    mechanisms = {"fast": torch._C._profiler._RecordFunctionFast,
                  "public": record_function}

    def bare(make) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with make("obs:x"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    def excess(make) -> float:
        with profile(activities=acts) as p:
            inner = []
            for _ in range(50):
                with make("obs:y"):
                    t0 = time.perf_counter()
                    time.sleep(1e-3)
                    inner.append(time.perf_counter() - t0)
        got = [e.time_range.elapsed_us() for e in p.events()
               if e.name == "obs:y" and e.device_type == DeviceType.CPU]
        return max(g - 1e6 * t for g, t in zip(got, inner))

    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    timed()
    out = {k: [] for k in ("no_profiler", "profiler", "range_fast",
                           "range_public")}
    for _ in range(reps):
        out["no_profiler"].append(timed())
        with profile(activities=acts):
            out["profiler"].append(timed())
            for k, make in mechanisms.items():
                out["range_" + k].append(bare(make))
    got = {k: min(v) for k, v in out.items()}
    for k, make in mechanisms.items():
        got["range_excess_" + k] = min(excess(make) for _ in range(reps))
    return got


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal at a small --img-res, no device "
                    "trace")
    ap.add_argument("--img-res", type=int, default=None)
    a = ap.parse_args(argv)
    # as the benchmark's entry point sets them, before numpy and torch load
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("search_spans_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from hassbench import harness
    from repro_torch.obs import Tracer, use_tracer
    cell = harness.find_cell(a.workload)
    tracer = Tracer()
    with use_tracer(tracer):
        s = harness.setup(cell, a.seed, dev, a.img_res)
        setup_counters = dict(tracer.counters)
        # the warm-up search's root comes before the window's
        first = sum(e["name"] == "search" and e["parent"] is None
                    for e in tracer.events)
        w = harness.run_window(s, a.seconds, trace=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for path in w.recorder_files:
        os.remove(path)
    out = {"workload": a.workload, "seed": a.seed,
           "card": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "searches": w.searches, "trials_per_s": w.trials / w.seconds}
    bench = harness.read_profile(w.profile)
    if bench is not None:
        out["device_idle"] = 100.0 * (1 - bench["busy_s"] / bench["wall_s"])
        out["profile"] = profile_readings(w.profile["prof"], bench["idle"])
        out["device_ops_ms_per_round"] = device_ops(
            bench["kernels"], out["profile"].get("obs_rounds", 0))
    recorded = searches(tracer.events, first + 1,
                        first + harness.RECORDED_SEARCHES)
    out["spans"] = span_readings(recorded)
    out["profiled_spans"] = span_readings(searches(tracer.events, first,
                                                   first))
    out["setup_spans_ms"] = setup_readings(tracer.events)
    out["setup_counters"] = setup_counters
    out["counters"] = {k: v - setup_counters.get(k, 0)
                       for k, v in tracer.counters.items()}
    passes = sum(e["name"] == "evaluate.pass" and e["t0"] >= w.t0
                 for e in tracer.events)
    out.update(per_pass(out["counters"], passes))
    out["span_cost_us"] = span_cost_us(dev)
    out["spans_a_round"] = sum(e["name"] not in ("trial", "search")
                               for e in recorded) / max(
                                   out["spans"].get("rounds", 1), 1)
    line = json.dumps(out, sort_keys=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
