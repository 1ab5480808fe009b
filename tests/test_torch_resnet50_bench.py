"""The benchmark's ResNet-50 configuration and its two new cells on the
CPU: the plain reference's layer table is the program's, its hardware
terms are bit-equal to the evaluator's, it measures what the evaluator
measures on seeded proposals at a small image size, and the control (TF32
operands, a float32 DSE) fails the cell's comparison; both new cells are
found with their files, and a short serial window passes its check."""
import gc
import os

import numpy as np
import pytest

from hassbench import harness, yardstick
from hassbench.reference import compare
from hassbench.reference.forward import Reference
from hassbench.reference.hardware import Hardware
from hassbench.reference.layers import load
from hassbench.tests.test_hassbench_reference import (FIELDS, _cfg,
                                                      _evaluator, _targets)

ARCH, BUDGET = "resnet50", 7434
CELLS = {"resnet50.search.b8": ("resnet50", "search.b8", 8),
         "resnet18.search.serial": ("resnet18", "search.serial", None)}


@pytest.fixture(scope="module")
def built():
    """(layers, params, images, evaluator) of ResNet-50 at 32 x 32."""
    return _evaluator(ARCH, BUDGET)


@pytest.mark.parametrize("res", [32, 224])
def test_the_reference_layer_table_is_the_programs(res):
    from repro_torch.models import cnn
    layers = load(ARCH, res, 1000)
    ours = [tuple(getattr(l, f) for f in FIELDS) for l in layers]
    theirs = [tuple(getattr(s, f) for f in FIELDS)
              for s in cnn.build_specs(_cfg(ARCH, res))]
    assert ours == theirs
    assert (len(layers), sum(l.prunable for l in layers)) == (72, 54)
    if res == 224:
        conf = harness.find_cell("resnet50.search.b8").config
        assert yardstick.network_macs(layers) == 4_089_184_256
        assert round(conf["gmac_per_image"] * 1e9) == \
            yardstick.network_macs(layers)
        assert (conf["layers"], conf["prunable_layers"]) == (72, 54)


def test_hardware_terms_are_bit_equal_to_the_programs(built):
    layers, _, _, ev = built
    L = len(ev.prunable)
    rng = np.random.default_rng(4)
    sw = rng.uniform(0, 0.95, (8, L)).astype(np.float32)
    sa = rng.uniform(0, 0.95, (8, L)).astype(np.float32)
    got = ev._metrics_batch(np.zeros(8, np.float32), sw, sa, None)
    hw = Hardware(layers, BUDGET, 600)
    assert hw.dense_thr == ev.dense_thr
    want = [hw.metrics(sw[i], sa[i]) for i in range(8)]
    assert compare.hw_number(got, want) == 0.0


@pytest.fixture(scope="module")
def measured(built):
    """On 4 seeded proposals, the dense one first: the evaluator's rows,
    the reference, its answers, and the control's answers."""
    layers, params, images, ev = built
    L = len(ev.prunable)
    t = _targets(L, 4, 13)
    rows = ev._pass(t[:, :L].astype(np.float32), t[:, L:].astype(np.float32),
                    None, 4)
    ref = Reference(layers, params, images)
    low = Reference(layers, params, images, "tf32")
    return (rows, ref, ref.evaluate(t[:, :L], t[:, L:]), ev,
            low.evaluate(t[:, :L], t[:, L:]))


@pytest.mark.parametrize("what", ["pruned", "clipped", "accuracy"])
def test_the_reference_measures_what_the_evaluator_measures(measured, what):
    rows, ref, r, ev, _ = measured
    if what == "pruned":
        assert np.array_equal(compare.counts(rows[1], ref.w_numel),
                              r["w_zeros"])
    elif what == "clipped":
        # as in the reference's own test: a clipped input's zeros may differ
        # by an element or two, a sum that cancels to exactly 0 in one
        # summation order and not in the other
        a_zeros = compare.counts(rows[2], ref.a_numel)
        assert np.abs(a_zeros - r["a_zeros"]).max() <= 2
        assert (r["a_band"][..., 0] <= r["a_zeros"]).all()
        assert (r["a_zeros"] <= r["a_band"][..., 1]).all()
        cand = {"acc": rows[0], "w_zeros": r["w_zeros"], "a_zeros": a_zeros}
        got = compare.device_numbers(cand, r, ref.dense_pred.numpy())
        limits = harness.find_cell("resnet50.search.b8").check["limits"]
        assert got["s_a_apart"] <= limits["s_a_apart"]
        assert got["s_a_layer_apart"] <= limits["s_a_layer_apart"]
    else:
        assert np.array_equal(rows[0], r["acc"])
        assert r["acc"][0] == 1.0
        assert np.array_equal(ref.dense_pred.numpy(), ev.dense_pred.numpy())


def test_the_control_fails_the_comparison(built, measured):
    """The reference with TF32 operands and its DSE in float32, put in the
    program's place, breaks a limit of the ResNet-50 cell."""
    layers = built[0]
    _, ref, r, _, c = measured
    n = len(c["acc"])
    hw64 = Hardware(layers, BUDGET, 600)
    hw32 = Hardware(layers, BUDGET, 600, "float32")
    got = compare.numbers(
        c, r, ref.dense_pred.numpy(),
        [hw32.metrics(c["s_w"][i], c["s_a"][i]) for i in range(n)],
        [hw64.metrics(c["s_w"][i], c["s_a"][i]) for i in range(n)])
    limits = harness.find_cell("resnet50.search.b8").check["limits"]
    assert got["s_w_mismatch"] == 0          # pruning computes no product
    assert got["s_a_apart"] > limits["s_a_apart"]
    assert got["hw_gap"] > limits["hw_gap"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_new_cells_are_found_with_their_files(name):
    config, traffic, batch = CELLS[name]
    cell = harness.find_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == config and cell.config["arch"] == config
    assert cell.config["img_res"] == 224
    assert cell.traffic["batch_size"] == batch
    assert (cell.traffic["trials"], cell.traffic["warmup_trials"]) == (96, 16)
    assert cell.check["sample"] == 256
    assert set(cell.check["limits"]) == {"s_w_mismatch", "acc_mismatch",
                                         "s_a_apart", "s_a_layer_apart",
                                         "hw_gap"}
    for sub, stem in (("traffic", traffic), ("workloads", name)):
        assert os.path.isfile(os.path.join(harness.ROOT, "hassbench", sub,
                                           stem + ".json"))
    assert {m["name"] for m in cell.end_to_end} == \
        {"trials_per_s", "round_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == \
        {"tpe_ask_ms", "evaluate_ms", "act_clip_batched_roofline",
         "search_mfu", "device_idle"}


def test_a_short_serial_window_passes_the_cells_check():
    """``resnet18.search.serial`` at 32 x 32 on the CPU: one trial a
    round, one shape-1 pass each, and the window's proposals pass the
    cell's limits."""
    cell = harness.find_cell("resnet18.search.serial")
    s = harness.setup(cell, 2 ** 31 + 27, "cpu", img_res=32)
    w = harness.run_window(s, 0.5, False)
    assert w.trials >= 1 and all(len(r.xs) == 1 for r in w.rounds)
    assert s.ev.batch_shapes == set()
    s.probe = s.ev = None
    gc.unfreeze()                   # as ``harness.run`` does after a window
    got = harness.check(s, w, sample=6)
    limits = cell.check["limits"]
    assert got["compared"] == min(w.trials, 6)
    assert all(got[k] <= limits[k] for k in limits), got
