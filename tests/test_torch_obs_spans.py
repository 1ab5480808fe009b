"""The port's spans inside the search round and the evaluator, on the CPU:
the tree ``hass_search`` and ``CNNEvaluator`` open under a ``Tracer``
(``search`` > ``round`` or ``trial`` > ``propose`` / ``evaluate`` /
``tell`` / ``record``; ``evaluate`` > ``evaluate.pass`` (>
``pass.readback``) and ``evaluate.dse``), the ``DSECache`` counter deltas
the ``evaluate.dse`` spans carry, the transcript with the tracer off and
on, and every span's ``obs:`` range in a ``torch.profiler`` profile.

One reduced ResNet-18 evaluator (32 x 32, 8 images, weights from a fixed
generator) serves the file; its DSE cache carries over from test to test,
as it does from search to search."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import reduce_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.hass import DSE_COUNTERS, CNNEvaluator, hass_search
from repro_torch.core.perf_model import FPGAModel
from repro_torch.models import cnn

torch.set_num_threads(2)

ROUND_CHILDREN = {"propose", "evaluate", "tell", "record"}


@functools.lru_cache(maxsize=None)
def _ev():
    cfg = reduce_config(RESNET18)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = cnn.init_params(cfg, gen, device="cpu")
    images = torch.randn((8, cfg.img_res, cfg.img_res, 3), generator=gen)
    return CNNEvaluator(cfg, params, images, FPGAModel(), budget=4096,
                        dse_iters=150)


def _search(tracer=None, recorder=None, **kw):
    ev = _ev()
    kw = dict(dict(iters=8, batch_size=3, seed=1, s_max=0.9), **kw)
    if tracer is None:
        return hass_search(ev, len(ev.names), recorder=recorder, **kw)
    with obs.use_tracer(tracer):
        return hass_search(ev, len(ev.names), recorder=recorder, **kw)


def _tree(tracer):
    """(spans by id, children ids by parent id)."""
    by_id = {e["id"]: e for e in tracer.events}
    kids = {}
    for e in tracer.events:
        kids.setdefault(e["parent"], []).append(e["id"])
    return by_id, kids


def _names(by_id, ids):
    return sorted(by_id[i]["name"] for i in ids)


def _assert_nested(tracer):
    """Every span lies inside its parent's interval, one level deeper."""
    by_id, _ = _tree(tracer)
    for e in tracer.events:
        if e["parent"] is None:
            assert e["depth"] == 0
            continue
        p = by_id[e["parent"]]
        assert e["depth"] == p["depth"] + 1, (e, p)
        assert p["t0"] <= e["t0"] <= e["t1"] <= p["t1"], (e, p)


def _assert_evaluate_tree(by_id, kids, evaluate_id):
    assert _names(by_id, kids[evaluate_id]) == ["evaluate.dse",
                                                "evaluate.pass"]
    for i in kids[evaluate_id]:
        if by_id[i]["name"] == "evaluate.pass":
            assert _names(by_id, kids[i]) == ["pass.readback"]
        else:
            assert i not in kids


def test_batched_search_opens_one_round_per_round_with_its_phases():
    tracer = obs.Tracer()
    _search(tracer)                                    # rounds 3 + 3 + 2
    by_id, kids = _tree(tracer)
    (root,) = kids[None]
    assert by_id[root]["name"] == "search"
    rounds = kids[root]
    assert [by_id[r]["name"] for r in rounds] == ["round"] * 3
    for r, k in zip(rounds, (3, 3, 2)):
        names = _names(by_id, kids[r])
        assert set(names) - {"trial"} == ROUND_CHILDREN
        assert names.count("trial") == k
        for n in ROUND_CHILDREN:
            assert names.count(n) == 1
        (ev_id,) = [i for i in kids[r] if by_id[i]["name"] == "evaluate"]
        _assert_evaluate_tree(by_id, kids, ev_id)
    assert sum(e["name"] == "evaluate.pass" for e in tracer.events) == 3
    _assert_nested(tracer)


def test_every_child_lies_inside_its_parent_and_ids_are_unique():
    tracer = obs.Tracer()
    _search(tracer, seed=4)
    ids = [e["id"] for e in tracer.events]
    assert len(set(ids)) == len(ids)
    by_id, _ = _tree(tracer)
    assert all(e["parent"] is None or e["parent"] in by_id
               for e in tracer.events)
    _assert_nested(tracer)


@pytest.mark.parametrize("seed", [2, 3])
def test_dse_span_deltas_sum_to_the_caches_change(seed):
    cache = _ev().dse_cache
    before = cache.stats()
    tracer = obs.Tracer()
    _search(tracer, seed=seed, iters=9)
    after = cache.stats()
    dse = [e["args"] for e in tracer.events if e["name"] == "evaluate.dse"]
    assert len(dse) == 3
    for k in DSE_COUNTERS:
        assert sum(a[k] for a in dse) == after[k] - before[k]
    assert sum(sum(a[k] for k in DSE_COUNTERS) for a in dse) == 9
    assert all(set(a) == set(DSE_COUNTERS) for a in dse)


def test_serial_search_gives_the_same_tree_under_trial():
    tracer = obs.Tracer()
    r = _search(tracer, batch_size=None, iters=4, seed=5)
    by_id, kids = _tree(tracer)
    (root,) = kids[None]
    trials = kids[root]
    assert [by_id[t]["name"] for t in trials] == ["trial"] * 4
    assert [by_id[t]["args"]["i"] for t in trials] == [0, 1, 2, 3]
    for t in trials:
        assert set(_names(by_id, kids[t])) == ROUND_CHILDREN
        assert len(kids[t]) == 4
        (ev_id,) = [i for i in kids[t] if by_id[i]["name"] == "evaluate"]
        _assert_evaluate_tree(by_id, kids, ev_id)
    assert sum(e["name"] == "evaluate.pass" for e in tracer.events) == 4
    assert len(r.trials) == 4
    _assert_nested(tracer)


def test_anchored_trial_has_no_propose():
    tracer = obs.Tracer()
    ev = _ev()
    x0 = np.zeros(2 * len(ev.names))
    _search(tracer, x0=x0, iters=4)                    # x0, then 3
    by_id, kids = _tree(tracer)
    (root,) = kids[None]
    first = by_id[kids[root][0]]
    assert first["name"] == "trial" and first["args"] == {"i": 0}
    assert _names(by_id, kids[first["id"]]) == ["evaluate", "record",
                                                "tell"]
    assert [by_id[i]["name"] for i in kids[root][1:]] == ["round"]
    _assert_nested(tracer)


@pytest.mark.parametrize("kw", [
    dict(batch_size=None), dict(batch_size=1),
    dict(batch_size=None, x0="dense"), dict(batch_size=1, x0="dense"),
])
def test_rounds_of_one_under_one_tracer_and_recorder(tmp_path, kw):
    """A serial search, ``batch_size=1`` and an anchored search: serial
    trials are ``trial(i)`` > the four phases, rounds of one are
    ``round`` > the four phases and one ``trial(i)``, the ``x0`` trial has
    no ``propose``; the recorder writes one record a trial, each the whole
    of its round, and the transcript is the untraced one."""
    ev = _ev()
    kw = dict(kw, iters=4, seed=6)
    if "x0" in kw:
        kw["x0"] = np.zeros(2 * len(ev.names))
    tracer = obs.Tracer()
    path = str(tmp_path / "run.jsonl")
    with obs.FlightRecorder(path) as rec:
        r = _search(tracer, recorder=rec, **kw)
    off = _search(**kw)
    for a, b in zip(off.trials, r.trials):
        assert np.array_equal(a.x, b.x)
        assert a.score == b.score and a.metrics == b.metrics
    by_id, kids = _tree(tracer)
    (root,) = kids[None]
    assert by_id[root]["name"] == "search" and len(kids[root]) == 4
    for i, o in enumerate(kids[root]):
        names = _names(by_id, kids[o])
        if i == 0 and "x0" in kw:
            assert by_id[o]["name"] == "trial"
            assert by_id[o]["args"] == {"i": 0}
            assert names == ["evaluate", "record", "tell"]
        elif kw["batch_size"] is None:
            assert by_id[o]["name"] == "trial"
            assert by_id[o]["args"] == {"i": i}
            assert names == sorted(ROUND_CHILDREN)
        else:
            assert by_id[o]["name"] == "round" and by_id[o]["args"] == {}
            assert names == sorted(ROUND_CHILDREN | {"trial"})
            (t,) = [c for c in kids[o] if by_id[c]["name"] == "trial"]
            assert by_id[t]["args"] == {"i": i} and t not in kids
        (ev_id,) = [c for c in kids[o] if by_id[c]["name"] == "evaluate"]
        _assert_evaluate_tree(by_id, kids, ev_id)
    _assert_nested(tracer)
    assert tracer.counters["search.trials"] == 4
    run = obs.load_run(path)
    cfg = run["header"]["config"]
    assert run["header"]["search"] == "hass_search"
    assert cfg["batch_size"] == kw["batch_size"] and cfg["iters"] == 4
    assert cfg["evaluator"] == "CNNEvaluator"
    assert [t["i"] for t in run["trials"]] == [0, 1, 2, 3]
    for j, (t, want) in enumerate(zip(run["trials"], r.trials)):
        assert t["score"] == want.score and t["round_size"] == 1
        assert set(t["phases"]) == {"propose", "evaluate", "tell"}
        assert t["phases"]["evaluate"] > 0
        assert (t["phases"]["propose"] == 0.0) == (j == 0 and "x0" in kw)
        assert sum(t["cache"][k] for k in DSE_COUNTERS) == 1
        assert t["engine"]
    foot = run["footer"]
    assert foot["n_trials"] == 4 and foot["best_score"] == r.best_score


@pytest.mark.parametrize("batch_size", [3, None])
def test_transcript_is_bit_identical_with_the_tracer_off_on_and_recording(
        tmp_path, batch_size):
    kw = dict(batch_size=batch_size, iters=6, seed=7)
    off = _search(**kw)
    on = _search(obs.Tracer(), **kw)
    with obs.FlightRecorder(str(tmp_path / "run.jsonl")) as rec:
        rec_on = _search(obs.Tracer(), recorder=rec, **kw)
    for other in (on, rec_on):
        assert len(other.trials) == len(off.trials)
        for a, b in zip(off.trials, other.trials):
            assert np.array_equal(a.x, b.x)
            assert a.score == b.score and a.metrics == b.metrics
        assert other.best_score == off.best_score
    run = obs.load_run(str(tmp_path / "run.jsonl"))
    assert len(run["trials"]) == 6


def test_recorder_phases_leave_the_record_span_out(tmp_path):
    """``propose``, ``evaluate`` and ``tell`` phases lie within the round's
    span; the recorder's write (``record``) follows ``tell``."""
    tracer = obs.Tracer()
    with obs.FlightRecorder(str(tmp_path / "run.jsonl")) as rec:
        _search(tracer, recorder=rec, iters=6, seed=8)
    run = obs.load_run(str(tmp_path / "run.jsonl"))
    firsts = [t for t in run["trials"] if t["phases"]["evaluate"] > 0]
    rounds = [e for e in tracer.events if e["name"] == "round"]
    records = [e for e in tracer.events if e["name"] == "record"]
    tells = [e for e in tracer.events if e["name"] == "tell"]
    assert len(firsts) == len(rounds) == len(records) == 2
    for t, r, rc, tl in zip(firsts, rounds, records, tells):
        assert sum(t["phases"].values()) <= r["t1"] - r["t0"]
        assert rc["t0"] >= tl["t1"]


def test_every_span_is_an_obs_range_of_the_profile():
    from torch.profiler import ProfilerActivity, profile
    tracer = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(tracer, iters=6, seed=9)
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(obs.trace.PROFILE_PREFIX)),
                    key=lambda e: e.time_range.start)
    spans = sorted((e for e in tracer.events if e["name"] != "trial"),
                   key=lambda e: e["t0"])             # trial: add_span
    assert [r.name for r in ranges] == ["obs:" + s["name"] for s in spans]
    by_id = {s["id"]: s for s in spans}
    for r, s in zip(ranges, spans):
        parent = by_id.get(s["parent"])
        if parent is None:
            assert r.cpu_parent is None or \
                not r.cpu_parent.name.startswith("obs:")
        else:
            assert r.cpu_parent is not None and \
                r.cpu_parent.name == "obs:" + parent["name"]
        dur_us = (s["t1"] - s["t0"]) * 1e6
        got_us = r.time_range.elapsed_us()
        assert abs(got_us - dur_us) <= max(50.0, 0.05 * dur_us), \
            (s["name"], got_us, dur_us)


def test_no_profile_range_without_a_profiler():
    """With no profiler recording a span opens no range."""
    tracer = obs.Tracer()
    with tracer.span("outer"):
        with tracer.span("inner") as sp:
            assert sp._range is None
    assert [e["name"] for e in tracer.events] == ["inner", "outer"]


def test_tracer_records_ids_and_parents_and_exports_them():
    tracer = obs.Tracer()
    with tracer.span("a", job=1):
        with tracer.span("b"):
            tracer.instant("mark")
        tracer.add_span("c", 0.0, 0.0)
    tracer.add_span("d", 0.0, 0.0, depth=3)
    ev = {e["name"]: e for e in tracer.events}
    assert ev["a"]["parent"] is None and ev["a"]["depth"] == 0
    assert ev["b"]["parent"] == ev["a"]["id"] and ev["b"]["depth"] == 1
    assert ev["mark"]["parent"] == ev["b"]["id"] and ev["mark"]["depth"] == 2
    assert ev["c"]["parent"] == ev["a"]["id"] and ev["c"]["depth"] == 1
    assert ev["d"]["parent"] is None and ev["d"]["depth"] == 3
    chrome = {e["name"]: e for e in tracer.to_chrome_trace()["traceEvents"]}
    assert chrome["a"]["args"] == {"job": 1, "id": ev["a"]["id"],
                                   "parent": None}
    assert chrome["b"]["args"] == {"id": ev["b"]["id"],
                                   "parent": ev["a"]["id"]}


def test_tracer_keeps_counters_and_spans_only():
    for t in (obs.Tracer(), obs.NULL_TRACER):
        for gone in ("gauge", "observe", "metrics", "export_metrics",
                     "gauges", "hists"):
            assert not hasattr(t, gone), gone
    tracer = obs.Tracer()
    tracer.count("n", 2)
    tracer.count("n")
    assert tracer.counters == {"n": 3}
