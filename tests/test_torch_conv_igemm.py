"""The convolutions of the batched CNN forward that are no plain product
(``cnn.is_igemm``: the 3 x 3s, the strided 1 x 1 projections, the stems)
as the implicit-GEMM kernel ``kernels.conv_igemm``: its plain version
against the grouped convolution the forward ran before, on every such
shape of ResNet-18, ResNet-50 and MobileNetV3-L at a reduced spatial size;
the route, on exactly those layers of a forward over more than one
proposal; the evaluator's ``pass.conv_igemms``. The tests marked ``cuda``
hold the kernel on the card against a float64 convolution and, bit for
bit, against cuDNN's grouped convolution (whose summation order the
kernel keeps), its epilogue against ``relu(y + b)``, and a captured
batched forward against its eager run; they skip where there is no GPU. This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_conv_igemm.py -m cuda -q
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import conv_igemm as igemm
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn

torch.set_num_threads(2)
# see the verify notes: torch's first CPU exp of a process can be off
torch.exp(torch.zeros(64))

ARCHS = ("resnet18", "resnet50", "mobilenetv3l")
ROUTED = {"resnet18": 20, "resnet50": 20, "mobilenetv3l": 1}


def _layers(arch, B=8):
    return [s for s in cnn.build_specs(get_config(arch))
            if cnn.is_igemm(s, B)]


#: every routed (cin, cout, k, stride, relu) of the three models
SHAPES = sorted({(s.cin, s.cout, s.k, s.stride, s.act == "relu")
                 for a in ARCHS for s in _layers(a)})
#: every routed (cin, cout, k, stride, input side) at 224 x 224
FULL = sorted({(s.cin, s.cout, s.k, s.stride, s.in_hw)
               for a in ARCHS for s in _layers(a)})


def _inputs(B, cin, cout, k, hw, device="cpu", n=2, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, hw, hw, B * cin), generator=gen, device=device)
    w = torch.randn((B, k, k, cin, cout), generator=gen,
                    device=device) / (k * cin ** 0.5)
    b = torch.randn((cout,), generator=gen, device=device) / 4
    return x, w, b


def _before(x, w, b, stride, relu):
    """The layer as ``forward_batched`` ran it before the kernel: the B
    weights as one HWIO weight of B * cout outputs, one grouped
    convolution, the bias repeated B times, the activation."""
    B, k, _, cin, cout = w.shape
    hwio = w.permute(1, 2, 3, 0, 4).reshape(k, k, cin, B * cout)
    y = cnn._conv(x, hwio, stride, (k - 1) // 2, B)
    return cnn._act(y + b.repeat(B), "relu" if relu else "none")


def _exact(x, w, b, stride, relu=False, absolute=False):
    """Each group's convolution in float64, group by group: -> (y, the
    same over |x| and |w| without the bias: the sum of |terms|)."""
    B, k, _, cin, cout = w.shape
    xs = x.double().permute(0, 3, 1, 2)
    ys, sums = [], []
    for g in range(B):
        xg = xs[:, g * cin:(g + 1) * cin]
        wg = w[g].double().permute(3, 2, 0, 1)
        ys.append(F.conv2d(xg, wg, b.double(), stride=stride,
                           padding=(k - 1) // 2))
        if absolute:
            sums.append(F.conv2d(xg.abs(), wg.abs(), None, stride=stride,
                                 padding=(k - 1) // 2))
    y = torch.cat(ys, 1).permute(0, 2, 3, 1)
    y = F.relu(y) if relu else y
    return y, (torch.cat(sums, 1).permute(0, 2, 3, 1) if absolute else None)


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("cin,cout,k,stride,relu", SHAPES,
                         ids=[f"{i}x{o}k{k}s{s}{'r' if r else ''}"
                              for i, o, k, s, r in SHAPES])
def test_plain_version_is_the_grouped_convolution(cin, cout, k, stride, relu,
                                                  B):
    """On the CPU the wrapper takes its plain version: the grouped
    convolution, bias and activation of the forward before the kernel, bit
    for bit, and each group's own convolution in float64 within float32
    rounding, at group b's columns."""
    hw = 9 if k == 7 else 5
    x, w, b = _inputs(B, cin, cout, k, hw, seed=cin + cout + k)
    with torch.no_grad():
        got = ops.conv_igemm(x, w, b, stride, relu, (k - 1) // 2)
        before = _before(x, w, b, stride, relu)
    ho = igemm.out_size(hw, k, stride, (k - 1) // 2)
    assert got.shape == (2, ho, ho, B * cout) and got.is_contiguous()
    assert torch.equal(got, before)
    exact, _ = _exact(x, w, b, stride, relu)
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_the_route_takes_exactly_the_other_conv_layers(arch, monkeypatch):
    """At B = 8 the kernel takes 20 / 20 / 1 layers of ResNet-18 / ResNet-50
    / MobileNetV3-L: every ``conv`` that ``is_gemm`` leaves, no depthwise
    layer; at B = 1 none. A batched forward calls the wrapper for exactly
    those layers, in order, with the evaluator's stacked weights; one
    proposal, and the plain forward, never."""
    specs = cnn.build_specs(get_config(arch))
    routed = _layers(arch)
    assert len(routed) == ROUTED[arch]
    assert not any(cnn.is_igemm(s, 1) for s in specs)
    for s in specs:
        both = cnn.is_gemm(s, 8) + cnn.is_igemm(s, 8)
        assert both == (s.kind == "conv")
    cfg = reduce_config(get_config(arch))
    specs = cnn.build_specs(cfg)
    want = [(s.k, s.cin, s.cout, s.stride) for s in specs
            if cnn.is_igemm(s, 2)]
    assert len(want) == ROUTED[arch]
    gen = torch.Generator()
    gen.manual_seed(3)
    params = cnn.init_params(cfg, gen, device="cpu")
    images = torch.randn((2, cfg.img_res, cfg.img_res, 3), generator=gen)

    def batched(B):
        weights = {s.name: torch.stack([params[s.name]["w"]] * B)
                   for s in specs if s.prunable}
        return cnn.forward_batched(cfg, params, weights, images,
                                   {n: torch.zeros(B) for n in weights})
    seen = []
    plain = ops.conv_igemm

    def recorded(x, w, b, stride, relu, pad):
        assert pad == (w.shape[1] - 1) // 2
        seen.append((w.shape[1], w.shape[3], w.shape[4], stride))
        return plain(x, w, b, stride, relu, pad)
    monkeypatch.setattr(ops, "conv_igemm", recorded)
    with torch.no_grad():
        batched(2)
        assert seen == want
        seen.clear()
        batched(1)
        cnn.forward(cfg, params, images)
    assert seen == []


def test_pass_conv_igemms_counts_the_kernels_launches(monkeypatch):
    """A reduced MobileNetV3-L evaluator's pass of two proposals counts
    one launch (its stem), with each wrapper call counted as the card's
    wrapper counts a launch; a pass of one proposal none; on the CPU,
    where the wrapper launches nothing, 0."""
    from repro_torch.core.hass import CNNEvaluator
    from repro_torch.core.perf_model import FPGAModel
    from repro_torch.obs import Tracer, use_tracer
    cfg = reduce_config(get_config("mobilenetv3l"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = cnn.init_params(cfg, gen, device="cpu")
    images = torch.randn((4, cfg.img_res, cfg.img_res, 3), generator=gen)
    ev = CNNEvaluator(cfg, params, images, FPGAModel(), budget=4096,
                      dse_iters=50)
    L = len(ev.prunable)
    s = np.random.default_rng(0).uniform(0, 0.9, (2, L)).astype(np.float32)
    tracer = Tracer()
    with use_tracer(tracer):
        ev._pass(s, s, None, 2)
    assert tracer.counters["pass.conv_igemms"] == 0
    monkeypatch.setitem(kernels._LAUNCHED, "conv_igemm",
                        kernels.launch_counts()["conv_igemm"])
    plain = ops.conv_igemm

    def launched(*args):
        out = plain(*args)
        kernels._LAUNCHED["conv_igemm"] += 1
        return out
    monkeypatch.setattr(ops, "conv_igemm", launched)
    with use_tracer(tracer):
        ev._pass(s, s, None, 2)
        ev._pass(s[:1], s[:1], None, 1)
    assert tracer.counters["pass.conv_igemms"] == ROUTED["mobilenetv3l"]


@pytest.mark.parametrize("cin,cout,k,stride,hw", FULL)
def test_tile_and_output_side_of_every_full_shape(cin, cout, k, stride, hw):
    """The output side is the convolution's; at B = 8, N = 8 a block takes
    128 output pixels where that gives two full waves of the card or more,
    else 64; every layer fills an H100 (132 SMs) at least once, and a card
    of half the SMs takes the 128-pixel tile wherever the H100 does."""
    ho = igemm.out_size(hw, k, stride, (k - 1) // 2)
    assert ho == -(-hw // stride)
    M = 8 * ho * ho
    tm = igemm.tile_m(M, cout, 8, 132)
    assert (tm == 128) == (-(-M // 128) * -(-cout // 64) * 8 >= 1056)
    assert -(-M // tm) * -(-cout // 64) * 8 >= 132
    assert igemm.tile_m(M, cout, 8, 66) == 128 or tm == 64


def test_the_bound_counts_the_layers_flops_and_bytes():
    """``bench_util.conv_bound_ms`` (chip_smoke.py's bound for the kernel):
    2 flops per MAC at the float32 FMA rate, or x, w, y and the bias moved
    once at the memory rate, whichever is longer."""
    from repro_torch.kernels import bench_util
    # ResNet-18's stem at B = 8, N = 8: 118 GFLOP, bound by operations
    x = torch.empty((8, 224, 224, 24))
    w = torch.empty((8, 7, 7, 3, 64))
    y = torch.empty((8, 112, 112, 512))
    ms, by = bench_util.conv_bound_ms(x, w, y)
    flops = 2.0 * 8 * 112 * 112 * 512 * 147
    assert by == "operations"
    assert ms == pytest.approx(flops / bench_util.FP32_FLOPS * 1e3)
    # a 1 x 1 of 4 channels reads and writes more than it computes
    x, w, y = (torch.empty((8, 56, 56, 32)), torch.empty((8, 1, 1, 4, 4)),
               torch.empty((8, 56, 56, 32)))
    ms, by = bench_util.conv_bound_ms(x, w, y)
    nbytes = 4 * (2 * 8 * 56 * 56 * 32 + 8 * 16 + 4)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / bench_util.HBM_BYTES_PER_S * 1e3)


def test_the_wrapper_refuses_what_is_no_grouped_convolution():
    x, w, b = _inputs(2, 16, 8, 3, 5)
    with pytest.raises(ValueError, match="not one grouped"):
        ops.conv_igemm(x[..., :-1], w, b, 1, False, 1)
    with pytest.raises(ValueError, match="not one grouped"):
        ops.conv_igemm(x, w, b[:-1], 1, False, 1)
    with pytest.raises(ValueError, match="takes x"):
        ops.conv_igemm(x, w[0], b, 1, False, 1)
    with pytest.raises(TypeError, match="float32"):
        ops.conv_igemm(x.double(), w.double(), b.double(), 1, False,
                       1)


# ------------------------------------------------------------------ #
# on the card
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check_full_float32(got, x, w, b, stride):
    """The kernel's sum of K = k * k * cin float32 FMAs and the bias add
    against float64: within gamma_{K+1} = (K + 1) 2^-24 of the sum of
    |terms| (plus |b|) at every element, the classical bound of a
    float32 dot product in any order; and within 1e-5 of the largest
    |output| everywhere, where a TF32 product lies ~1e-3 off."""
    B, k, _, cin, cout = w.shape
    exact, terms = _exact(x, w, b, stride, absolute=True)
    gap = (got.double() - exact).abs()
    gamma = (k * k * cin + 1) * 2.0 ** -24
    bound = gamma * (terms + b.double().abs().repeat(B)) + 1e-30
    assert bool((gap <= bound).all()), (gap / bound).max().item()
    assert gap.max().item() <= 1e-5 * exact.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,hw", FULL)
def test_cuda_kernel_is_full_float32_at_every_full_shape(cuda, cin, cout, k,
                                                         stride, hw):
    """B = 8 proposals of N = 8 images, as the evaluator's pass has them,
    with TF32 off as the evaluator sets it: within float32 rounding of a
    float64 convolution, and the plain version's (cuDNN's grouped
    convolution's) result bit for bit, bias and relu included, as the
    reference's cuDNN convolution gives it; and at a ragged pixel count (N
    = 3 at an odd side), which leaves the last tile of rows partly empty,
    within float32 rounding."""
    from repro_torch.core.hass import _float32_convolutions
    pad = (k - 1) // 2
    for n, side in ((8, hw), (3, hw // 2 + 1)):
        x, w, b = _inputs(8, cin, cout, k, side, cuda, n=n, seed=cin * k)
        with torch.no_grad(), _float32_convolutions():
            got = ops.conv_igemm(x, w, b, stride, False, pad)
            if n == 8:
                for relu in (False, True):
                    assert torch.equal(
                        ops.conv_igemm(x, w, b, stride, relu, pad),
                        ref.conv_igemm_ref(x, w, b, stride, relu, pad))
        torch.cuda.synchronize()
        _check_full_float32(got, x, w, b, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,hw", [(3, 64, 7, 2, 224),
                                                  (64, 128, 3, 2, 56),
                                                  (512, 512, 3, 1, 7),
                                                  (3, 16, 3, 2, 224)])
def test_cuda_epilogue_is_relu_of_y_plus_b_bit_for_bit(cuda, cin, cout, k,
                                                       stride, hw):
    """The epilogue's bias and relu are ``relu(y + b)`` on the kernel's own
    sum y (its output with a zero bias), bit for bit; two launches are
    bit-equal."""
    x, w, b = _inputs(8, cin, cout, k, hw, cuda, n=8, seed=7)
    pad = (k - 1) // 2
    with torch.no_grad():
        y = ops.conv_igemm(x, w, torch.zeros_like(b), stride, False, pad)
        plus = ops.conv_igemm(x, w, b, stride, False, pad)
        relu = ops.conv_igemm(x, w, b, stride, True, pad)
        again = ops.conv_igemm(x, w, b, stride, True, pad)
        want = y + b.repeat(8)
    assert torch.equal(plus, want)
    assert torch.equal(relu, F.relu(want))
    assert torch.equal(relu, again)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """The kernel copies w in 16-byte runs and reads contiguous tensors:
    on the card the wrapper raises for cout % 4 != 0 or a strided x, where
    the plain version on the CPU takes either."""
    x, w, b = _inputs(2, 16, 6, 3, 5, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.conv_igemm(x, w, b, 1, False, 1)
    x, w, b = _inputs(2, 16, 8, 3, 5, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv_igemm(x.transpose(1, 2), w, b, 1, False, 1)
    assert ops.conv_igemm(x.cpu(), w[..., :6].cpu(), b[:6].cpu(), 1, False,
                          1).shape \
        == (2, 5, 5, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_captured_forward_batched_equals_its_eager_run(cuda, arch):
    """A reduced model's batched forward of 8 proposals captured into a CUDA
    graph: each replay bit-equal to the eager run; the graph holds one
    launch of the kernel per routed layer, and each replay adds them to
    the launch counts."""
    from repro_torch.core.hass import _float32_convolutions
    from repro_torch.kernels.graph import warm_and_capture
    cfg = reduce_config(get_config(arch))
    specs = cnn.build_specs(cfg)
    gen = torch.Generator()
    gen.manual_seed(5)
    params = cnn.init_params(cfg, gen, device="cuda")
    images = torch.randn((8, cfg.img_res, cfg.img_res, 3),
                         generator=gen).to(cuda)
    B = 8
    weights = {s.name: torch.stack([params[s.name]["w"] * (1 + b / 8)
                                    for b in range(B)])
               for s in specs if s.prunable}
    taus = {n: torch.linspace(0.0, 0.3, B, device=cuda) for n in weights}

    def run():
        return cnn.forward_batched(cfg, params, weights, images, taus)
    with torch.no_grad(), _float32_convolutions():
        eager = run()
        graph, _, static, _ = warm_and_capture(
            run, torch.cuda.graph_pool_handle(), cuda)
        assert graph.held["conv_igemm"] == ROUTED[arch]
        before = kernels.launch_counts()["conv_igemm"]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(static[0], eager[0])
            for n in eager[1]:
                assert torch.equal(static[1][n], eager[1][n]), n
    assert kernels.launch_counts()["conv_igemm"] - before == \
        2 * ROUTED[arch]


def test_the_timing_tool_lists_every_routed_layer_once():
    """``tools/conv_igemm_torch.py`` times each distinct routed shape once
    and counts its layers: 20 / 20 / 1, ResNet-18's stem first and
    MobileNetV3-L's hswish stem alone."""
    from tools import conv_igemm_torch as tool
    got = tool.shapes(cnn, get_config)
    assert list(got) == list(ARCHS)
    for arch, rows in got.items():
        assert sum(r[-1] for r in rows) == ROUTED[arch]
        assert len({r[:-1] for r in rows}) == len(rows)
    assert got["resnet18"][0] == (3, 64, 7, 2, 224, "relu", 1)
    assert got["mobilenetv3l"] == [(3, 16, 3, 2, 224, "hswish", 1)]
