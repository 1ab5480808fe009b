"""The 1 x 1 stride-1 convolutions of the CNN forwards as one strided-batched
product on the NHWC activations (``cnn._conv_gemm``): against the grouped
convolution the other layers take (``cnn._conv``), on every such shape of
ResNet-50 and MobileNetV3-L at a reduced spatial size; on exactly the layers
of that shape in the batched forward over more than one proposal; written in
place, with no copy. The tests
marked ``cuda`` hold the product on the card in full float32 and a captured
batched forward against its eager run; they skip where there is no GPU.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_conv_gemm.py -m cuda -q
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.paper_cnns import RESNET50
from repro_torch.models import cnn

torch.set_num_threads(2)
# see the verify notes: torch's first CPU exp of a process can be off
torch.exp(torch.zeros(64))

ROUTED = {"resnet50": 33, "mobilenetv3l": 30, "resnet18": 0}
HW = 4          # the reduced spatial size of the shape tests


def _shapes(arch):
    """Every distinct (cin, cout) of ``arch``'s 1 x 1 stride-1 layers."""
    specs = cnn.build_specs(get_config(arch))
    return sorted({(s.cin, s.cout) for s in specs if cnn.is_gemm(s, 8)})


SHAPES = [(a, cin, cout) for a in ("resnet50", "mobilenetv3l")
          for cin, cout in _shapes(a)]


def _inputs(B, cin, cout, device="cpu", n=2, hw=HW, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, hw, hw, B * cin), generator=gen, device=device)
    w = torch.randn((B, cin, cout), generator=gen, device=device) / cin ** 0.5
    return x, w


def _grouped(x, w):
    """The same layer as ``forward_batched`` ran it before: the B weights
    as HWIO with B * cout outputs, one grouped convolution."""
    B, cin, cout = w.shape
    hwio = w.permute(1, 0, 2).reshape(1, 1, cin, B * cout)
    return cnn._conv(x, hwio, 1, 0, B)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("arch,cin,cout", SHAPES,
                         ids=[f"{a}-{i}x{o}" for a, i, o in SHAPES])
def test_conv_gemm_matches_the_grouped_convolution(arch, cin, cout, B):
    x, w = _inputs(B, cin, cout, seed=cin + cout)
    with torch.no_grad():
        got = cnn._conv_gemm(x, w)
        want = _grouped(x, w)
    assert got.shape == want.shape == (2, HW, HW, B * cout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ROUTED))
def test_the_route_takes_exactly_the_1x1_stride1_layers(arch, monkeypatch):
    """The batched forward routes each 1 x 1 stride-1 layer, in order, and
    no other, through the product, which ``kernels.product_counts``
    counts; over one proposal, and in the plain forward, every layer stays
    a convolution."""
    cfg = reduce_config(get_config(arch))
    specs = cnn.build_specs(cfg)
    want = [(s.cin, s.cout) for s in specs if cnn.is_gemm(s, 3)]
    assert len(want) == ROUTED[arch]
    assert not any(cnn.is_gemm(s, 1) for s in specs)
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
    gemm = cnn._conv_gemm

    def recorded(x, w):
        seen.append((w.shape[1], w.shape[2]))
        return gemm(x, w)
    monkeypatch.setattr(cnn, "_conv_gemm", recorded)
    with torch.no_grad():
        batched(3)
        assert seen == want
        seen.clear()
        batched(1)
        cnn.forward(cfg, params, images)
        assert seen == []
    monkeypatch.setattr(cnn, "_conv_gemm", gemm)
    before = kernels.product_counts()["conv_gemm"]
    with torch.no_grad():
        batched(2)
    assert kernels.product_counts()["conv_gemm"] - before == len(want)
    assert "conv_gemm" not in kernels.launch_counts()


class _Ops(TorchDispatchMode):
    """Every aten op called under it, with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


@pytest.mark.parametrize("B", [1, 8])
def test_the_product_writes_the_nhwc_output_in_place(B):
    """One ``bmm.out`` over views: its input shares x's storage, its output
    the returned tensor's, which is contiguous NHWC; no op copies."""
    x, w = _inputs(B, 256, 64)
    with torch.no_grad(), _Ops() as ops:
        y = cnn._conv_gemm(x, w)
    names = [str(f) for f, _, _ in ops.calls]
    products = [(a, k) for f, a, k in ops.calls if f == torch.ops.aten.bmm.out]
    assert len(products) == 1, names
    (a, b), k = products[0]
    assert not any(n.startswith(("aten.copy", "aten.clone", "aten._to_copy",
                                 "aten.permute", "aten.bmm.default"))
                   for n in names), names
    assert y.shape == (2, HW, HW, B * 64) and y.is_contiguous()
    assert k["out"].untyped_storage().data_ptr() == \
        y.untyped_storage().data_ptr()
    assert a.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert b.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    assert k["out"].stride() == (64, B * 64, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tests hold the card's product")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,hw", [(64, 256, 56), (2048, 512, 7),
                                         (1024, 256, 14), (960, 160, 7),
                                         (16, 64, 112)])
def test_cuda_conv_gemm_is_full_float32(cuda, cin, cout, hw):
    """On the card, with TF32 off as the evaluator has it: matmul precision
    "highest"; the product within float32 rounding of a float64 product (a
    TF32 product is ~1e-3 off) and of the grouped convolution."""
    from repro_torch.core.hass import _float32_convolutions
    B = 8
    x, w = _inputs(B, cin, cout, cuda, n=8, hw=hw)
    with torch.no_grad(), _float32_convolutions():
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        got = cnn._conv_gemm(x, w)
        grouped = _grouped(x, w)
    exact = torch.bmm(x.double().reshape(-1, B, cin).transpose(0, 1),
                      w.double()).transpose(0, 1).reshape(got.shape)
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    torch.testing.assert_close(got, grouped, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_captured_forward_batched_equals_its_eager_run(cuda):
    """A reduced ResNet-50's batched forward captured into a CUDA graph and
    replayed: bit-equal to its eager run; the graph holds one product per
    1 x 1 stride-1 layer."""
    from repro_torch.core.hass import _float32_convolutions
    from repro_torch.kernels.graph import warm_and_capture
    cfg = reduce_config(RESNET50)
    specs = cnn.build_specs(cfg)
    gen = torch.Generator()
    gen.manual_seed(5)
    params = cnn.init_params(cfg, gen, device="cuda")
    images = torch.randn((8, cfg.img_res, cfg.img_res, 3),
                         generator=gen).to(cuda)
    B = 4
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
        graph.replay()
    torch.cuda.synchronize()
    assert graph.held["conv_gemm"] == ROUTED["resnet50"]
    assert torch.equal(static[0], eager[0])
    for n in eager[1]:
        assert torch.equal(static[1][n], eager[1][n]), n
