"""ConvNeXt-T on the port's batched search path, and the benchmark's cells
``convnext_t.search.b8`` and ``mobilenetv3l.search.serial``, on the CPU: the
program's layer table is the reference's; its hardware terms are bit-equal;
the evaluator
measures what the reference measures at 32 x 32 at B = 8 and B = 1, the
control and a planted LayerNorm fault do not; ``pass.layer_norms`` counts
23 a pass; an unknown activation raises; the implicit-GEMM kernel's plain
version pads as it is told; both new cells are found with their files, and
a short serial window of ``mobilenetv3l.search.serial`` passes its check.
The test marked ``cuda`` holds the kernel bit-equal to its plain version at
ConvNeXt-T's four routed shapes on the card and skips elsewhere. The
reference's own ConvNeXt-T tests (``hassbench/tests``) run here too.

On the CPU the program and the reference sum the 1 x 1 layers in other
orders (a channels-last convolution or a batched product against the
reference's NCHW convolution), and a ConvNet without a ReLU has no exact
zeros: one clip decision within rounding of tau changes every later layer's
input. So the comparison at the cell's limits (``compare.numbers`` at 0)
runs the program with its convolutions put in the reference's order: each
proposal's convolution on a contiguous NCHW copy, as the reference runs it
(``in_reference_order``); the routing, clip, LayerNorm, GELU, residuals,
pooling, head and counting are the program's own. With the CPU's own orders
a proposal is compared layer by layer up to its first count that differs,
which must lie within the reference's rounding band or two elements of its
count, as the reference's own test holds it against an independent module.
The card's check (``hassbench/run.py``) compares every layer of the program
as it runs there."""
import gc
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hassbench import harness, yardstick
from hassbench.metrics import layer_norm_roofline
from hassbench.reference import compare
from hassbench.reference.forward import BAND, Reference
from hassbench.reference.hardware import Hardware
from hassbench.reference.layers import load
# the reference's ConvNeXt-T tests, collected here as well
from hassbench.tests.test_hassbench_convnext_reference import (  # noqa: F401
    built, test_a_planted_fault_breaks_the_agreement,
    test_an_unknown_kind_or_activation_raises,
    test_hardware_prices_59_stages,
    test_ln_rows_take_nothing_from_the_normal_draw,
    test_the_existing_tables_pad_by_half_the_kernel, test_the_table_at_224,
    test_the_reference_agrees_with_an_independent_module)
from hassbench.tests.test_hassbench_reference import (FIELDS, _cfg,
                                                      _evaluator, _targets)
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn

torch.set_num_threads(2)
# see the verify notes: torch's first CPU exp of a process can be off
torch.exp(torch.zeros(64))

ARCH, BUDGET, CELL = "convnext_t", 7434, "convnext_t.search.b8"
CELLS = {CELL: ("convnext_t", "search.b8", 8),
         "mobilenetv3l.search.serial": ("mobilenetv3l", "search.serial",
                                        None)}
#: ConvNeXt-T's LayerNorms: the stem's, three downsampling layers', one
#: a block and the head's
LAYER_NORMS = 1 + 3 + 18 + 1
#: (cin, cout, k, stride, input side) of the layers the kernel takes
ROUTED = [(3, 96, 4, 4, 224), (96, 192, 2, 2, 56), (192, 384, 2, 2, 28),
          (384, 768, 2, 2, 14)]


@pytest.fixture(scope="module")
def program():
    """(layers, params, images, evaluator) of ConvNeXt-T at 32 x 32."""
    return _evaluator(ARCH, BUDGET)


def _nchw(x, w, stride, pad, groups):
    """NHWC x, HWIO w: the reference's convolution, on a contiguous NCHW
    copy of x and an OIHW view of w, back to contiguous NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1),
                 None, stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _reference_order(m):
    """Put the program's three convolution routes in the reference's
    summation order: the one-proposal and depthwise convolution, the
    implicit-GEMM route and the batched 1 x 1 product, each proposal's
    group as ``_nchw``."""
    def igemm(x, w, bias, stride, relu, pad):
        B, cin = w.shape[0], w.shape[3]
        y = torch.cat([_nchw(x[..., b * cin:(b + 1) * cin], w[b], stride,
                             pad, 1) for b in range(B)], -1) + bias.repeat(B)
        return F.relu(y) if relu else y

    def gemm(x, w):
        B, cin, cout = w.shape
        return torch.cat([_nchw(x[..., b * cin:(b + 1) * cin],
                                w[b].reshape(1, 1, cin, cout), 1, 0, 1)
                          for b in range(B)], -1)
    m.setattr(cnn, "_conv", _nchw)
    m.setattr(ops, "conv_igemm", igemm)
    m.setattr(cnn, "_conv_gemm", gemm)


@pytest.fixture(scope="module")
def ordered():
    """``program``'s evaluator built with its convolutions in the
    reference's order (its dense forward gives the clip thresholds)."""
    with pytest.MonkeyPatch.context() as m:
        _reference_order(m)
        return _evaluator(ARCH, BUDGET)


@pytest.fixture
def in_reference_order(monkeypatch):
    """The program's convolutions in the reference's order for one test."""
    _reference_order(monkeypatch)


def _beyond(numbers):
    """The device checks that lie beyond the cell's limits."""
    limits = harness.find_cell(CELL).check["limits"]
    return {k: v for k, v in numbers.items() if v > limits[k]}


@pytest.mark.parametrize("res", [32, 224])
def test_the_reference_layer_table_is_the_programs(res):
    layers = load(ARCH, res, 1000)
    fields = FIELDS + ("padding",)
    ours = [tuple(getattr(l, f) for f in fields) for l in layers]
    theirs = [tuple(getattr(s, f) for f in fields)
              for s in cnn.build_specs(_cfg(ARCH, res))]
    assert ours == theirs
    specs = cnn.build_specs(_cfg(ARCH, res))
    assert (len(specs), sum(s.prunable for s in specs)) == (101, 41)
    if res == 224:
        conf = harness.find_cell(CELL).config
        macs = sum(s.macs for s in specs)
        assert macs == yardstick.network_macs(layers) == 4_455_531_264
        assert round(conf["gmac_per_image"] * 1e9) == macs
        assert (conf["layers"], conf["prunable_layers"]) == (101, 41)
        assert (conf["arch"], conf["img_res"], conf["num_classes"]) == \
            (ARCH, 224, 1000)


def test_the_four_shapes_the_kernel_takes():
    """At B = 8 the kernel takes the unpadded stem and the three
    downsampling layers, the product the 36 pointwise layers; the
    depthwise layers and one proposal stay on cuDNN."""
    specs = cnn.build_specs(_cfg(ARCH, 224))
    assert [(s.cin, s.cout, s.k, s.stride, s.in_hw) for s in specs
            if cnn.is_igemm(s, 8)] == ROUTED
    assert all(s.padding == 0 for s in specs if cnn.is_igemm(s, 8))
    assert sum(cnn.is_gemm(s, 8) for s in specs) == 36
    assert not any(cnn.is_igemm(s, 1) or cnn.is_gemm(s, 1) for s in specs)


def test_hardware_terms_are_bit_equal_to_the_programs(program):
    layers, _, _, ev = program
    L = len(ev.prunable)
    rng = np.random.default_rng(4)
    sw = rng.uniform(0, 0.95, (8, L)).astype(np.float32)
    sa = rng.uniform(0, 0.95, (8, L)).astype(np.float32)
    got = ev._metrics_batch(np.zeros(8, np.float32), sw, sa, None)
    hw = Hardware(layers, BUDGET, 600)
    assert len(hw.costs) == len(ev.layers) == 59
    assert hw.dense_thr == ev.dense_thr
    want = [hw.metrics(sw[i], sa[i]) for i in range(8)]
    assert compare.hw_number(got, want) == 0.0


def _apart(cand, r, ref):
    """Proposals whose first count that differs from the reference's lies
    outside both its rounding band and two elements of it (the module
    docstring says why a count after it is not compared); and whether the
    pruned weights' counts and the accuracies are the reference's."""
    bad = 0
    for b in range(len(cand["a_zeros"])):
        for j in range(cand["a_zeros"].shape[1]):
            got, want = cand["a_zeros"][b, j], r["a_zeros"][b, j]
            if got != want:
                lo, hi = r["a_band"][b, j]
                bad += not (lo <= got <= hi or abs(got - want) <= 2)
                break
    exact = bool(np.array_equal(cand["w_zeros"], r["w_zeros"])) and \
        compare.device_numbers(cand, r, ref.dense_pred.numpy())[
            "acc_mismatch"] == 0
    return bad, exact


def _measure(program, B, seed=13):
    layers, params, images, ev = program
    L = len(ev.prunable)
    t = _targets(L, B, seed)
    rows = ev._pass(t[:, :L].astype(np.float32), t[:, L:].astype(np.float32),
                    None, B)
    reference = Reference(layers, params, images)
    r = reference.evaluate(t[:, :L], t[:, L:])
    cand = {"acc": rows[0], "w_zeros": compare.counts(rows[1],
                                                      reference.w_numel),
            "a_zeros": compare.counts(rows[2], reference.a_numel)}
    return cand, r, reference, t


@pytest.mark.parametrize("B", [8, 1])
def test_the_reference_measures_what_the_evaluator_measures(
        ordered, in_reference_order, B):
    """With the convolutions in the reference's order, the four device
    checks of ``compare.numbers`` read 0 over every layer."""
    cand, r, reference, _ = _measure(ordered, B)
    assert compare.device_numbers(cand, r, reference.dense_pred.numpy()) \
        == {"s_w_mismatch": 0, "acc_mismatch": 0, "s_a_apart": 0.0,
            "s_a_layer_apart": 0.0}
    assert r["acc"][0] == 1.0
    assert np.array_equal(reference.dense_pred.numpy(),
                          ordered[3].dense_pred.numpy())


@pytest.mark.parametrize("B", [8, 1])
def test_with_the_cpus_own_orders_each_proposal_agrees_to_its_first_gap(
        program, B):
    """The program as it runs on the CPU: each proposal's counts up to its
    first that differs, and that one within the rounding band or two
    elements; the pruned weights and accuracies exact."""
    cand, r, reference, _ = _measure(program, B)
    assert _apart(cand, r, reference) == (0, True)
    assert r["acc"][0] == 1.0
    assert np.array_equal(reference.dense_pred.numpy(),
                          program[3].dense_pred.numpy())
    # the dense network: within the rounding band of the largest logit
    dense = torch.from_numpy(program[3].dense_logits)
    assert float((dense - reference.dense_logits).abs().max()) <= \
        BAND * float(reference.dense_logits.abs().max())


def test_the_control_fails_the_comparison(program):
    """The reference with TF32 operands and its DSE in float32, put in the
    program's place: its dense logits leave the rounding band, its counts
    break the cell's device checks, proposals leave the reference's band
    at a first differing count, and it breaks ``hw_gap``."""
    layers, params, images, _ = program
    L = sum(l.prunable for l in layers)
    t = _targets(L, 8, 13)
    reference = Reference(layers, params, images)
    r = reference.evaluate(t[:, :L], t[:, L:])
    low = Reference(layers, params, images, "tf32")
    c = low.evaluate(t[:, :L], t[:, L:])
    assert float((low.dense_logits - reference.dense_logits).abs().max()) > \
        BAND * float(reference.dense_logits.abs().max())
    assert _beyond(compare.device_numbers(c, r, reference.dense_pred.numpy()))
    bad, _ = _apart(c, r, reference)
    assert bad >= 1
    hw64 = Hardware(layers, BUDGET, 600)
    hw32 = Hardware(layers, BUDGET, 600, "float32")
    gap = compare.hw_number(
        [hw32.metrics(c["s_w"][i], c["s_a"][i]) for i in range(8)],
        [hw64.metrics(c["s_w"][i], c["s_a"][i]) for i in range(8)])
    assert gap > harness.find_cell(CELL).check["limits"]["hw_gap"]


def test_a_layer_norm_over_all_proposals_fails_the_comparison(
        ordered, in_reference_order, monkeypatch):
    """A planted fault: the batched LayerNorm over all B * C channels of a
    pixel in place of each proposal's C."""
    def over_all(x, p, C):
        reps = x.shape[-1] // C
        return F.layer_norm(x, x.shape[-1:], p["g"].repeat(reps),
                            p["b"].repeat(reps), cnn.LN_EPS)
    monkeypatch.setattr(cnn, "_layer_norm", over_all)
    cand, r, reference, _ = _measure(ordered, 8)
    assert _beyond(compare.device_numbers(cand, r,
                                          reference.dense_pred.numpy()))


#: planted faults late in the network, each after many layers whose counts
#: the comparison has passed: (name, attribute of ``cnn``, the fault made
#: from the function it replaces, for B proposals)
LATE_FAULTS = [
    ("head_ln_skipped", "_layer_norm",
     lambda ln, B: lambda x, p, C: x if x.dim() == 2 else ln(x, p, C)),
    ("stage_3_layer_norms_skipped", "_layer_norm",
     lambda ln, B: lambda x, p, C:
         x if C == 768 and x.dim() == 4 else ln(x, p, C)),
    ("stage_3_gelu_in_tanh_form", "_act",
     lambda act, B: lambda x, name:
         F.gelu(x, approximate="tanh")
         if name == "gelu" and x.shape[-1] == B * 3072 else act(x, name)),
]


@pytest.mark.parametrize("fault,attr,make", LATE_FAULTS,
                         ids=[f[0] for f in LATE_FAULTS])
def test_a_late_fault_fails_the_comparison(ordered, in_reference_order,
                                           monkeypatch, fault, attr, make):
    """Faults in the last stage and the head, where the counts of every
    earlier layer agree, break the device checks at B = 8."""
    monkeypatch.setattr(cnn, attr, make(getattr(cnn, attr), 8))
    cand, r, reference, _ = _measure(ordered, 8)
    assert _beyond(compare.device_numbers(cand, r,
                                          reference.dense_pred.numpy()))


@pytest.mark.parametrize("B", [8, 1])
def test_pass_layer_norms_counts_each_layer_norm(program, B):
    """23 LayerNorms a pass at any B, on any device; the pass's
    convolutions through the product, 36 at B > 1."""
    from repro_torch.obs import Tracer, use_tracer
    ev = program[3]
    L = len(ev.prunable)
    s = np.random.default_rng(0).uniform(0, 0.9, (B, L)).astype(np.float32)
    tracer = Tracer()
    with use_tracer(tracer):
        ev._pass(s, s, None, B)
        ev._pass(s, s, None, B)
    assert tracer.counters["pass.layer_norms"] == 2 * LAYER_NORMS
    assert tracer.counters["pass.conv_gemms"] == (2 * 36 if B > 1 else 0)
    assert "layer_norm" in kernels.product_counts()
    assert "layer_norm" not in kernels.launch_counts()


def test_an_unknown_activation_raises():
    cfg = _cfg("resnet18", 32)
    specs = cnn.build_specs(cfg)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = cnn.init_params(cfg, gen, device="cpu")
    images = torch.randn((2, 32, 32, 3), generator=gen)
    odd = [specs[0].__class__(**{**specs[0].__dict__, "act": "swish"})] + \
        specs[1:]
    weights = {s.name: params[s.name]["w"][None] for s in specs
               if s.prunable}
    taus = {n: torch.zeros(1) for n in weights}
    with pytest.raises(ValueError, match="activation"):
        cnn._act(torch.ones(2), "swish")
    for fn in (lambda: cnn.forward(cfg, params, images),
               lambda: cnn.forward_batched(cfg, params, weights, images,
                                           taus)):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(cnn, "build_specs", lambda c: odd)
            with pytest.raises(ValueError, match="activation"), \
                    torch.no_grad():
                fn()


def test_init_params_gives_a_layer_norm_its_gain_and_shift():
    cfg = _cfg(ARCH, 32)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = cnn.init_params(cfg, gen, device="cpu")
    for s in cnn.build_specs(cfg):
        if s.kind == "ln":
            assert torch.equal(params[s.name]["g"], torch.ones(s.cout))
            assert torch.equal(params[s.name]["b"], torch.zeros(s.cout))


@pytest.mark.parametrize("cin,cout,k,stride,hw", ROUTED)
def test_the_plain_version_pads_as_it_is_told(cin, cout, k, stride, hw):
    """At the stem's and the downsampling layers' shapes (a reduced side),
    pad 0: ``conv_igemm_ref`` is each group's ``F.conv2d`` with padding 0,
    and the wrapper on the CPU returns it."""
    side = 2 * k * 3 if k == 2 else 24
    gen = torch.Generator()
    gen.manual_seed(cin + k)
    B = 2
    x = torch.randn((2, side, side, B * cin), generator=gen)
    w = torch.randn((B, k, k, cin, cout), generator=gen) / (k * cin ** 0.5)
    b = torch.randn((cout,), generator=gen) / 4
    with torch.no_grad():
        got = ref.conv_igemm_ref(x, w, b, stride, False, 0)
        assert torch.equal(ops.conv_igemm(x, w, b, stride, False, 0), got)
        for g in range(B):
            want = F.conv2d(x[..., g * cin:(g + 1) * cin].permute(0, 3, 1, 2),
                            w[g].permute(3, 2, 0, 1), b, stride=stride,
                            padding=0).permute(0, 2, 3, 1)
            assert torch.allclose(got[..., g * cout:(g + 1) * cout], want,
                                  rtol=0, atol=1e-5)
    assert got.shape[1] == side // stride


def test_the_layer_norm_roofline_reads_the_trace():
    """The reader: the LayerNorms' least time over their device time a
    round of the profiled search; nothing without a profile or without
    one of its kernels."""
    cell = harness.find_cell(CELL)
    layers = load(ARCH, 224, 1000)
    bound = layer_norm_roofline.bound_s(layers, 8, 8)
    elems = sum(8 * 8 * l.cout * l.out_hw ** 2 for l in layers
                if l.kind == "ln")
    assert bound == pytest.approx(8 * elems / yardstick.HBM_BYTES_PER_S)

    class Round:
        def __init__(self, search):
            self.search = search
    window = type("W", (), {"rounds": [Round(0)] * 12 + [Round(1)] * 12})
    name = ("void at::native::(anonymous namespace)::"
            "vectorized_layer_norm_kernel<float, float, false>")
    prof = {"kernels": {name: [12 * 2 * bound, 276], "other": [1.0, 5]}}
    view = harness.RunView(cell, layers, window, prof, [])
    assert layer_norm_roofline.read(view) == pytest.approx(50.0)
    view.profile = {"kernels": {"other": [1.0, 5]}}
    assert layer_norm_roofline.read(view) is None
    view.profile = None
    assert layer_norm_roofline.read(view) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_new_cells_are_found_with_their_files(name):
    config, traffic, batch = CELLS[name]
    cell = harness.find_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == config and cell.config["arch"] == config
    assert cell.config["img_res"] == 224
    assert cell.traffic["batch_size"] == batch
    assert (cell.traffic["trials"], cell.traffic["warmup_trials"]) == (96, 16)
    assert cell.check == harness.find_cell("resnet50.search.b8").check
    for sub, stem in (("traffic", traffic), ("workloads", name)):
        assert os.path.isfile(os.path.join(harness.ROOT, "hassbench", sub,
                                           stem + ".json"))
    assert {m["name"] for m in cell.end_to_end} == \
        {"trials_per_s", "round_ms_p95", "setup_s"}
    metrics = {"tpe_ask_ms", "evaluate_ms", "act_clip_batched_roofline",
               "search_mfu", "device_idle"}
    if config == ARCH:
        metrics.add("layer_norm_roofline")
    assert {m["name"] for m in cell.per_layer} == metrics
    for m in cell.per_layer:
        reader = harness.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
            (m["unit"], m["layer"], m["moves"])


def test_a_short_serial_window_of_mobilenetv3l_passes_the_cells_check():
    """``mobilenetv3l.search.serial`` at 32 x 32 on the CPU: one trial a
    round, one shape-1 pass each, and the window's proposals pass the
    cell's limits."""
    cell = harness.find_cell("mobilenetv3l.search.serial")
    s = harness.setup(cell, 2 ** 31 + 29, "cpu", img_res=32)
    w = harness.run_window(s, 0.5, False)
    assert w.trials >= 1 and all(len(r.xs) == 1 for r in w.rounds)
    assert s.ev.batch_shapes == set()
    s.probe = s.ev = None
    gc.unfreeze()                   # as ``harness.run`` does after a window
    got = harness.check(s, w, sample=6)
    limits = cell.check["limits"]
    assert got["compared"] == min(w.trials, 6)
    assert all(got[k] <= limits[k] for k in limits), got


# ------------------------------------------------------------------ #
# on the card
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,hw", ROUTED)
def test_cuda_kernel_is_its_plain_version_at_convnext_shapes(cuda, cin, cout,
                                                             k, stride, hw):
    """B = 8 proposals of N = 8 images at 224 x 224, TF32 off: the kernel
    with pad 0 is cuDNN's grouped convolution bit for bit, and a second
    launch is the first."""
    from repro_torch.core.hass import _float32_convolutions
    gen = torch.Generator(device="cpu")
    gen.manual_seed(cin * k)
    x = torch.randn((8, hw, hw, 8 * cin), generator=gen).to(cuda)
    w = (torch.randn((8, k, k, cin, cout), generator=gen)
         / (k * cin ** 0.5)).to(cuda)
    b = (torch.randn((cout,), generator=gen) / 4).to(cuda)
    with torch.no_grad(), _float32_convolutions():
        got = ops.conv_igemm(x, w, b, stride, False, 0)
        again = ops.conv_igemm(x, w, b, stride, False, 0)
        want = ref.conv_igemm_ref(x, w, b, stride, False, 0)
    torch.cuda.synchronize()
    assert got.shape == (8, hw // stride, hw // stride, 8 * cout)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
