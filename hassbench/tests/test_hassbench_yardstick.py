"""The yardstick's arithmetic, pinned to the values the repository's
records hold, and to the program's own counts (the test may import the
program; the yardstick may not)."""
import pytest

from hassbench import yardstick
from hassbench.reference.layers import load


def test_clip_bound_of_a_resnet18_round_of_eight_is_pinned():
    layers = load("resnet18", 224, 1000)
    inputs = yardstick.clip_inputs(layers, 8)
    assert len(inputs) == 21
    total_ms = 1e3 * sum(yardstick.clip_bound_s(e, 8) for e in inputs)
    assert total_ms == pytest.approx(0.33367, abs=5e-6)
    # a serial pass (one proposal): the bound that PERF.md's kernel table
    # gives for B = 1
    assert 1e3 * sum(yardstick.clip_bound_s(e, 1) for e in inputs) == \
        pytest.approx(0.04171, abs=5e-6)


@pytest.mark.parametrize("arch,gmac", [("resnet18", 1.814),
                                       ("mobilenetv3l", 0.217)])
def test_network_macs_equal_the_programs_layer_costs(arch, gmac):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.perf_model import cnn_layer_costs
    macs = yardstick.network_macs(load(arch, 224, 1000))
    cfg = ModelConfig(name=arch, family="cnn", cnn_arch=arch, img_res=224,
                      num_classes=1000)
    assert macs == sum(l.macs for l in cnn_layer_costs(cfg))
    assert macs / 1e9 == pytest.approx(gmac, abs=5e-4)
    assert yardstick.forward_flops(load(arch, 224, 1000), 8, 8) == \
        2.0 * macs * 64


def test_peaks_are_the_data_sheets():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.FP32_FLOPS == 67e12
    assert yardstick.TF32_FLOPS == 495e12
    assert yardstick.BF16_FLOPS == 989e12


def test_busy_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert yardstick.busy(spans) == pytest.approx(4.0)
    assert yardstick.union(spans) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert yardstick.gaps(spans, -1.0, 8.0) == [
        (-1.0, 0.0), (2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    assert yardstick.gaps(spans, 0.0, 7.0) == [(2.0, 3.0), (4.0, 6.0)]


def test_busy_union_matches_the_smoke_scripts_union():
    """``chip_smoke.busy_us``'s loop, over the same spans."""
    spans = [(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (8.0, 12.0), (20.0, 21.0)]
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    assert yardstick.busy(spans) == busy

