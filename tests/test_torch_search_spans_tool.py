"""``tools/search_spans_torch.py``'s readings on synthetic spans and a
synthetic profile: each instant of a device idle gap put under the
innermost program span over it (a gap under none goes to ``(none)``), the
rollups the benchmark's own buckets are compared with, and the per-round
readings ``pass_wait_ms``, ``pass_bubble_ms``, ``dse_ms`` and
``dse_cold_share``; the evaluator's set-up spans in ms."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from tools import search_spans_torch as tool


def test_innermost_range_wins_and_a_gap_under_none_is_named_so():
    ranges = [(0.0, 10.0, "round"), (2.0, 8.0, "evaluate"),
              (3.0, 6.0, "evaluate.pass"), (5.0, 6.0, "pass.readback")]
    gaps = [(5.2, 5.8), (1.0, 1.5), (6.5, 7.5), (11.0, 12.0), (3.0, 3.5)]
    idle = tool.idle_by_span(gaps, ranges)
    assert idle == pytest.approx({"pass.readback": 0.6, "round": 0.5,
                                  "evaluate": 1.0, "(none)": 1.0,
                                  "evaluate.pass": 0.5})
    roll = tool.rollup(idle)
    assert roll == pytest.approx({"pass": 1.1, "evaluate": 2.1,
                                  "outside_evaluate": 1.5, "none": 1.0})


def test_a_gap_straddling_two_spans_is_split_at_their_edges():
    ranges = [(0.0, 10.0, "round"), (0.0, 4.0, "propose"),
              (4.0, 9.0, "evaluate"), (5.0, 6.0, "evaluate.dse")]
    assert tool.idle_by_span([(1.0, 4.0)], ranges) == {"propose": 3.0}
    assert tool.idle_by_span([(3.0, 6.0)], ranges, split=False) == \
        {"evaluate": 3.0}
    split = tool.idle_by_span([(3.0, 6.0), (8.5, 12.0)], ranges)
    assert split == pytest.approx({"propose": 1.0, "evaluate": 1.5,
                                   "evaluate.dse": 1.0, "round": 1.0,
                                   "(none)": 2.0})


@pytest.mark.parametrize("a, b, ok", [
    (10e-3, 10.4e-3, True),          # 4 % apart
    (10e-3, 10.6e-3, False),         # 6 % apart
    (1e-3, 1.09e-3, True),           # 9 % apart, 0.09 ms
    (1e-3, 1.2e-3, False),           # 0.2 ms
])
def test_agreement_is_five_percent_or_a_tenth_of_a_ms(a, b, ok):
    assert tool.agrees(a, b) is ok


def _span(sid, name, t0, t1, parent=None, **args):
    return {"id": sid, "name": name, "t0": t0, "t1": t1, "parent": parent,
            "depth": 0, "args": args}


def _search_events(base, i0, rounds, readback, dse, counters):
    """One search's spans from ``base`` s: ``rounds`` rounds of 10 s, each
    with a readback of ``readback`` s and a DSE of ``dse`` s."""
    ev = [_span(i0, "search", base, base + 10 * rounds)]
    i = i0 + 1
    for r in range(rounds):
        t = base + 10 * r
        ev += [_span(i, "round", t, t + 10, i0),
               _span(i + 1, "propose", t, t + 3, i),
               _span(i + 2, "evaluate", t + 3, t + 9, i),
               _span(i + 3, "evaluate.pass", t + 3, t + 7, i + 2),
               _span(i + 4, "pass.readback", t + 7 - readback, t + 7, i + 3),
               _span(i + 5, "evaluate.dse", t + 7, t + 7 + dse, i + 2,
                     **counters),
               _span(i + 6, "tell", t + 9, t + 9.5, i),
               _span(i + 7, "record", t + 9.5, t + 10, i),
               _span(i + 8, "trial", t, t + 10, i, i=8 * r)]
        i += 9
    return ev


def test_span_readings_of_the_recorded_searches():
    counters = dict(hits=1, warm_l1=2, warm_l2=1, cold_runs=4)
    events = (_search_events(0.0, 1, 2, 3.0, 1.0, counters)
              + _search_events(100.0, 100, 3, 2.0, 1.5, counters)
              + _search_events(200.0, 200, 1, 9.0, 9.0, counters))
    got = tool.span_readings(tool.searches(events, 1, 1))
    assert got["rounds"] == 3
    assert got["pass_wait_ms"] == pytest.approx(2e3)
    assert got["dse_ms"] == pytest.approx(1.5e3)
    assert got["dse_cold_share"] == pytest.approx(50.0)
    assert got["dse_counters"] == {k: 3 * v for k, v in counters.items()}
    split = got["evaluate_split_ms"]
    assert split["evaluate"] == pytest.approx(6e3)
    assert split["evaluate.pass"] == pytest.approx(4e3)
    assert split["evaluate_self"] == pytest.approx(0.5e3)
    assert got["ms_per_round"]["record"] == pytest.approx(0.5e3)
    both = tool.span_readings(tool.searches(events, 0, 1))
    assert both["rounds"] == 5
    assert tool.span_readings([]) == {}


def _event(name, a_us, b_us, on_device=False, annotation=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if on_device
        else DeviceType.CPU, time_range=SimpleNamespace(start=a_us, end=b_us),
        is_user_annotation=annotation)


def test_profile_readings_put_device_idle_under_the_program_spans():
    """Two rounds of 100 us, device work at 20-50, 52-55 and 70-75 us of
    each and once more at 250-255 us, past the last round, where no span
    is; ``obs:`` ranges nest round > evaluate > evaluate.pass >
    pass.readback, and evaluate > evaluate.dse. The device side of a
    range (its annotation) and the benchmark's labels are no device
    work; the labels' idle comes from the benchmark's own reader."""
    ev = []
    for r in (0, 100):
        ev += [_event("obs:round", r, r + 100),
               _event("obs:propose", r, r + 10),
               _event("obs:evaluate", r + 10, r + 80),
               _event("hassbench.pass", r + 12, r + 60),
               _event("obs:evaluate.pass", r + 13, r + 60),
               _event("obs:pass.readback", r + 30, r + 60),
               _event("obs:pass.readback", r + 30, r + 60, on_device=True,
                      annotation=True),
               _event("hassbench.pass", r + 12, r + 60, on_device=True),
               _event("obs:evaluate.dse", r + 60, r + 78),
               _event("kernel", r + 20, r + 50, on_device=True),
               _event("kernel", r + 52, r + 55, on_device=True),
               _event("kernel", r + 70, r + 75, on_device=True)]
    ev.append(_event("kernel", 250, 255, on_device=True))
    labels = {"hassbench.pass": 14e-6, "hassbench.evaluate": 30e-6,
              "hassbench.search_loop": 120e-6}
    got = tool.profile_readings(SimpleNamespace(events=lambda: ev), labels)
    assert got["obs_rounds"] == 2 and got["span_counts"]["round"] == 2
    assert got["busy_s"] == pytest.approx(81e-6)
    assert got["interval_s"] == pytest.approx(245e-6)       # 10 .. 255
    per_round = 1e-6 * 1e3 / 2                              # us -> ms
    # 10-13 evaluate's, 13-20 evaluate.pass's; 50-52 the readback's;
    # 55-60 the readback's, 60-70 the DSE's; 75-120 runs through the DSE
    # (3), evaluate (2), round 0 (20), round 1's propose (10), evaluate
    # (3) and evaluate.pass (7); 175-250 through the DSE (3), evaluate
    # (2), round 1 (20), then 50 under no span
    assert got["idle_by_span_ms_per_round"] == pytest.approx(
        {"evaluate.pass": 14 * per_round, "pass.readback": 14 * per_round,
         "evaluate.dse": 26 * per_round, "evaluate": 10 * per_round,
         "round": 40 * per_round, "propose": 10 * per_round,
         "(none)": 50 * per_round})
    assert got["rollup_ms_per_round"] == pytest.approx(
        {"pass": 28 * per_round, "evaluate": 64 * per_round,
         "outside_evaluate": 100 * per_round, "none": 50 * per_round})
    # by midpoints: 10-20 (15, evaluate.pass), 50-52 (readback), 55-70
    # (62.5, the DSE), 75-120 (97.5, round 0), 150-152, 155-170, and
    # 175-250 (212.5, under no span)
    assert got["rollup_by_midpoint_ms_per_round"] == pytest.approx(
        {"pass": 14 * per_round, "evaluate": 44 * per_round,
         "outside_evaluate": 120 * per_round, "none": 75 * per_round})
    assert got["idle_by_label_ms_per_round"] == pytest.approx(
        {"hassbench.pass": 14 * per_round,
         "hassbench.evaluate": 30 * per_round,
         "hassbench.search_loop": 120 * per_round})
    assert got["pass_bubble_ms"] == pytest.approx(14 * per_round)
    assert got["none_share"] == pytest.approx(50 / 164)
    assert got["pass_matches_label"] and got["outside_matches_label"]
    off = dict(labels, **{"hassbench.pass": 14e-6 + 1e-3})
    got = tool.profile_readings(SimpleNamespace(events=lambda: ev), off)
    assert not got["pass_matches_label"] and got["outside_matches_label"]


def test_profile_without_device_work_reads_nothing():
    ev = [_event("obs:round", 0, 10), _event("hassbench.pass", 1, 2)]
    assert tool.profile_readings(SimpleNamespace(events=lambda: ev),
                                 {}) == {}


def test_setup_readings_sum_each_build_span_and_its_own_time():
    ev = [_span(1, "evaluator.build", 0.0, 1.0),
          _span(2, "build.dense_forward", 0.0, 0.1, 1),
          _span(3, "build.act_samples", 0.1, 0.6, 1),
          _span(4, "build.dense_dse", 0.6, 0.7, 1),
          _span(5, "build.weight_sort", 0.7, 0.95, 1),
          _span(6, "search", 1.0, 2.0),
          _span(7, "evaluator.build", 3.0, 3.5),
          _span(8, "build.act_samples", 3.0, 3.2, 7)]
    got = tool.setup_readings(ev)
    assert got == pytest.approx({
        "evaluator.build": 1500.0, "build.dense_forward": 100.0,
        "build.act_samples": 700.0, "build.dense_dse": 100.0,
        "build.weight_sort": 250.0, "evaluator.build_self": 350.0})
    assert tool.setup_readings(ev[5:6]) == {}


def test_device_ops_per_round_sum_names_cut_alike_longest_first():
    long = "k" * 130
    got = tool.device_ops({"copy": [0.002, 4], long + "a": [0.01, 2],
                           long + "b": [0.02, 2]}, 2)
    assert list(got) == ["k" * 120, "copy"]
    assert got["k" * 120] == pytest.approx([15.0, 2.0])
    assert got["copy"] == pytest.approx([1.0, 2.0])


def test_per_pass_counters_divide_by_the_window_s_passes():
    counters = {"pass.clip_launches": 210, "pass.conv_igemms": 200,
                "search.trials": 80}
    assert tool.per_pass(counters, 10) == {"clip_launches_per_pass": 21.0,
                                           "conv_gemms_per_pass": 0.0,
                                           "conv_igemms_per_pass": 20.0,
                                           "layer_norms_per_pass": 0.0}
    assert tool.per_pass(counters, 0) == {}
