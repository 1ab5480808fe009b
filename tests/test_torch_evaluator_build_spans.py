"""The evaluator's set-up under a tracer, on the CPU at 32 x 32: one
``evaluator.build`` span with its four ``build.*`` children, each once;
the counter ``evaluator.act_sample_elems`` at the elements of every
prunable layer's input over the images; ``pass.clip_launches`` at the
batched clip's launches in a pass, ``pass.conv_gemms`` at its 1 x 1
stride-1 convolutions and ``pass.conv_igemms`` at the implicit-GEMM
kernel's launches; and without a tracer the same set-up bits."""
import numpy as np
import pytest
import torch

from hassbench import inputs, yardstick
from hassbench.reference.layers import load
from repro_torch import kernels
from repro_torch.obs import Tracer, use_tracer

BUILD = ("build.dense_forward", "build.act_samples", "build.dense_dse",
         "build.weight_sort")
ARCHS = {"resnet18": 12234, "resnet50": 7434}


def _build(arch, tracer=None):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.hass import CNNEvaluator
    from repro_torch.core.perf_model import FPGAModel
    layers = load(arch, 32, 1000)
    params, images = inputs.make(layers, 3, 8, 32, torch.device("cpu"))
    cfg = ModelConfig(name=arch, family="cnn", cnn_arch=arch, img_res=32,
                      num_classes=1000)
    if tracer is None:
        return layers, CNNEvaluator(cfg, params, images, FPGAModel(),
                                    budget=ARCHS[arch], dse_iters=600,
                                    cost_cfg=cfg)
    with use_tracer(tracer):
        return layers, CNNEvaluator(cfg, params, images, FPGAModel(),
                                    budget=ARCHS[arch], dse_iters=600,
                                    cost_cfg=cfg)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def traced(request):
    tracer = Tracer()
    layers, ev = _build(request.param, tracer)
    return request.param, layers, ev, tracer


def test_the_build_spans_open_once_each_inside_evaluator_build(traced):
    _, _, _, tracer = traced
    roots = [e for e in tracer.events if e["name"] == "evaluator.build"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    for name in BUILD:
        got = [e for e in tracer.events if e["name"] == name]
        assert len(got) == 1, name
        assert got[0]["parent"] == roots[0]["id"]
        assert roots[0]["t0"] <= got[0]["t0"] <= got[0]["t1"] <= \
            roots[0]["t1"]
    assert {e["name"] for e in tracer.events} == {"evaluator.build", *BUILD}


def test_act_sample_elems_counts_every_prunable_input(traced):
    _, layers, ev, tracer = traced
    want = sum(yardstick.clip_inputs(layers, ev.images.shape[0]))
    assert tracer.counters == {"evaluator.act_sample_elems": want}


def test_without_a_tracer_the_set_up_is_bit_equal(traced):
    arch, _, ev, _ = traced
    _, plain = _build(arch)
    assert np.array_equal(plain.dense_logits, ev.dense_logits)
    assert torch.equal(plain._act_q, ev._act_q)
    assert plain.dense_thr == ev.dense_thr


def test_clip_launches_count_the_batched_kernels_launches_in_a_pass(
        traced, monkeypatch):
    """On the CPU the clip runs its plain version and launches nothing;
    with each call counted as the card's wrapper counts a launch, a pass
    counts one per prunable layer. ``pass.conv_gemms`` counts the 1 x 1
    stride-1 layers of a pass of more than one proposal, whose product
    runs on any device; ``pass.conv_igemms`` the implicit-GEMM kernel's
    launches, one per other ``conv`` layer of such a pass (none at B =
    1), counted as the clip's."""
    arch, _, ev, _ = traced
    L = len(ev.prunable)
    G = {"resnet18": 0, "resnet50": 33}[arch]
    I = {"resnet18": 20, "resnet50": 20}[arch]
    rng = np.random.default_rng(0)
    s = rng.uniform(0, 0.9, (2, L)).astype(np.float32)
    tracer = Tracer()
    with use_tracer(tracer):
        ev._pass(s, s, None, 2)
    assert tracer.counters == {"pass.clip_launches": 0, "pass.conv_gemms": G,
                               "pass.conv_igemms": 0, "pass.layer_norms": 0}
    # the process's own launch counts are put back after the test
    for name in ("act_clip_count_batched", "conv_igemm"):
        monkeypatch.setitem(kernels._LAUNCHED, name,
                            kernels.launch_counts()[name])

    def launching(name, plain):
        def launched(*args):
            out = plain(*args)
            kernels._LAUNCHED[name] += 1
            return out
        return launched
    monkeypatch.setattr(kernels.ops, "act_clip_batched", launching(
        "act_clip_count_batched", kernels.ops.act_clip_batched))
    monkeypatch.setattr(kernels.ops, "conv_igemm", launching(
        "conv_igemm", kernels.ops.conv_igemm))
    with use_tracer(tracer):
        ev._pass(s, s, None, 2)
        ev._pass(s[:1], s[:1], None, 1)
    want = {"pass.clip_launches": 2 * L, "pass.conv_gemms": 2 * G,
            "pass.conv_igemms": I, "pass.layer_norms": 0}
    assert tracer.counters == want
    ev._pass(s, s, None, 2)
    assert tracer.counters == want
