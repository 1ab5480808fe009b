"""On the card, at a cell's own size: a short window's proposals pass the
cell's check and the control (the reference with TF32, its DSE in float32,
in the program's place) fails it; a traced run reads every per-layer
metric. Run with ``python -m pytest hassbench/tests -m cuda``."""
import time

import pytest

from hassbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["resnet18.search.b8",
                                  "mobilenetv3l.search.b8"])
def test_the_program_passes_and_the_control_fails_on_the_card(card, cell):
    c = harness.find_cell(cell)
    s = harness.setup(c, 31)
    w = harness.run_window(s, 3.0, False)
    s.probe = s.ev = None
    limits = c.check["limits"]
    prog = harness.check(s, w, "program")
    assert all(prog[k] <= limits[k] for k in limits), prog
    ctrl = harness.check(s, w, "control")
    assert not all(ctrl[k] <= limits[k] for k in limits), ctrl


def test_a_traced_run_reads_every_per_layer_metric(card):
    c = harness.find_cell("resnet18.search.b8")
    out = harness.run(c, 32, 10.0, True, time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    for name in ("act_clip_batched_roofline", "search_mfu", "device_idle"):
        assert 0.0 < out["metrics"][name]["value"] <= 100.0
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
