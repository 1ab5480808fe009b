"""The plain reference against the program on the CPU at a small image
size: the same layer tables, the same pruned counts, clipped counts and
accuracy on the same proposals, bit-equal hardware terms; and the control
(TF32 operands, a float32 DSE) fails the comparison."""

import numpy as np
import pytest
import torch

from hassbench import harness, inputs
from hassbench.reference import compare
from hassbench.reference.forward import Reference
from hassbench.reference.hardware import Hardware
from hassbench.reference.layers import load

ARCHS = (("resnet18", 12234), ("mobilenetv3l", 4324))
FIELDS = ("name", "kind", "cin", "cout", "k", "stride", "in_hw", "out_hw",
          "act", "input_from", "residual_from", "se_ratio")


def _cfg(arch, res):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=arch, family="cnn", cnn_arch=arch, img_res=res,
                       num_classes=1000)


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
@pytest.mark.parametrize("res", [32, 224])
def test_layer_tables_equal_the_programs(arch, res):
    from repro_torch.models import cnn
    ours = [tuple(getattr(l, f) for f in FIELDS) for l in load(arch, res, 1000)]
    theirs = [tuple(getattr(s, f) for f in FIELDS)
              for s in cnn.build_specs(_cfg(arch, res))]
    assert ours == theirs


def _evaluator(arch, budget, res=32, seed=5):
    from repro_torch.core.hass import CNNEvaluator
    from repro_torch.core.perf_model import FPGAModel
    layers = load(arch, res, 1000)
    params, images = inputs.make(layers, seed, 8, res, torch.device("cpu"))
    ev = CNNEvaluator(_cfg(arch, res), params, images, FPGAModel(),
                      budget=budget, dse_iters=600, cost_cfg=_cfg(arch, res))
    return layers, params, images, ev


def _targets(L, n, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 0.95, (n, 2 * L))
    t[0] = 0.0                      # the dense proposal
    return t


@pytest.mark.parametrize("arch,budget", ARCHS)
def test_hardware_terms_are_bit_equal_to_the_programs(arch, budget):
    layers, _, _, ev = _evaluator(arch, budget)
    L = len(ev.prunable)
    rng = np.random.default_rng(3)
    sw = rng.uniform(0, 0.95, (12, L)).astype(np.float32)
    sa = rng.uniform(0, 0.95, (12, L)).astype(np.float32)
    got = ev._metrics_batch(np.zeros(12, np.float32), sw, sa, None)
    hw = Hardware(layers, budget, 600)
    assert hw.dense_thr == ev.dense_thr
    want = [hw.metrics(sw[i], sa[i]) for i in range(12)]
    assert compare.hw_number(got, want) == 0.0
    low = Hardware(layers, budget, 600, "float32")
    assert compare.hw_number([low.metrics(sw[i], sa[i]) for i in range(12)],
                             want) > 1e-6


@pytest.mark.parametrize("arch,budget", ARCHS)
def test_reference_measures_what_the_evaluator_measures(arch, budget):
    layers, params, images, ev = _evaluator(arch, budget)
    L = len(ev.prunable)
    t = _targets(L, 8, 11)
    rows = ev._pass(t[:, :L].astype(np.float32), t[:, L:].astype(np.float32),
                    None, 8)
    ref = Reference(layers, params, images)
    r = ref.evaluate(t[:, :L], t[:, L:])
    assert np.array_equal(compare.counts(rows[1], ref.w_numel), r["w_zeros"])
    # a clipped input's zeros may differ by an element or two: a sum that
    # cancels to exactly 0 in one summation order and not in the other
    a_zeros = compare.counts(rows[2], ref.a_numel)
    assert np.abs(a_zeros - r["a_zeros"]).max() <= 2
    assert np.array_equal(rows[0], r["acc"])
    assert r["acc"][0] == 1.0
    assert np.array_equal(ref.dense_pred.numpy(), ev.dense_pred.numpy())
    cand = {"acc": rows[0], "w_zeros": r["w_zeros"], "a_zeros": a_zeros}
    got = compare.device_numbers(cand, r, ref.dense_pred.numpy())
    assert got["s_w_mismatch"] == 0 and got["acc_mismatch"] == 0
    assert got["s_a_apart"] <= 0.02
    assert (r["a_band"][..., 0] <= r["a_zeros"]).all()
    assert (r["a_zeros"] <= r["a_band"][..., 1]).all()


@pytest.mark.parametrize("arch,budget", ARCHS)
def test_the_control_fails_the_comparison(arch, budget):
    """The reference with TF32 operands and its DSE in float32, put in the
    program's place, breaks a limit of the cell."""
    layers, params, images, _ = _evaluator(arch, budget, seed=9)
    L = sum(l.prunable for l in layers)
    t = _targets(L, 16, 12)
    ref = Reference(layers, params, images)
    r = ref.evaluate(t[:, :L], t[:, L:])
    low = Reference(layers, params, images, "tf32")
    c = low.evaluate(t[:, :L], t[:, L:])
    hw64 = Hardware(layers, budget, 600)
    hw32 = Hardware(layers, budget, 600, "float32")
    got = compare.numbers(
        c, r, ref.dense_pred.numpy(),
        [hw32.metrics(c["s_w"][i], c["s_a"][i]) for i in range(16)],
        [hw64.metrics(c["s_w"][i], c["s_a"][i]) for i in range(16)])
    limits = harness.find_cell(f"{arch}.search.b8").check["limits"]
    assert got["s_w_mismatch"] == 0          # pruning computes no product
    assert got["s_a_apart"] > limits["s_a_apart"]
    assert got["hw_gap"] > limits["hw_gap"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from hassbench.reference.forward import _round_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0e-5, 1.0 + 2 ** -12], dtype=torch.float32)
    y = _round_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9]
    assert y[5] == 1.0
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_acc_gap_reads_the_margin_the_count_needs():
    dense = np.array([0, 1])
    z = np.array([[[2.0, 1.0], [0.0, 1.0]]])      # both images agree
    assert compare.acc_margin_gap(1.0, z[0], dense) == 0.0
    # the candidate says one image lost its class: the cheaper flip is the
    # second image's margin, 1 / 1
    assert compare.acc_margin_gap(0.5, z[0], dense) == 0.5
    assert compare.acc_margin_gap(float("nan"), z[0], dense) == float("inf")
