"""ConvNeXt-T's layer table and the reference's LayerNorm, exact GELU and
explicit padding, on the CPU: the table's counts; the reference against an
independent ``nn.Module`` ConvNeXt-T (``nn.Conv2d``, ``nn.LayerNorm``,
``nn.GELU`` and ``nn.Linear`` on channels-last, as the official code is
written) on the same seeded parameters, dense and on clipped proposals;
three planted faults that break that agreement; unknown kinds and
activations refused; the existing tables' padding unchanged."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from hassbench import inputs, yardstick
from hassbench.reference import forward
from hassbench.reference.forward import BAND, Reference, act_tau, weight_tau
from hassbench.reference.hardware import Hardware
from hassbench.reference.layers import Layer, load

ARCH, RES, IMAGES, CLASSES = "convnext_t", 32, 8, 1000
DEPTHS, DIMS = (3, 3, 9, 3), (96, 192, 384, 768)


class _Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dw = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.ln = nn.LayerNorm(c, eps=1e-6)
        self.pw1 = nn.Linear(c, 4 * c)
        self.act = nn.GELU()
        self.pw2 = nn.Linear(4 * c, c)
        # the layer scale, which the benchmark draws folded into pw2
        self.gamma = nn.Parameter(torch.ones(c))

    def forward(self, x, clip, tag):
        y = self.ln(self.dw(x).permute(0, 2, 3, 1))
        y = self.act(self.pw1(clip(f"{tag}pw1", y)))
        y = self.gamma * self.pw2(clip(f"{tag}pw2", y))
        return x + y.permute(0, 3, 1, 2)


class _ConvNeXtT(nn.Module):
    """ConvNeXt-T as facebookresearch/ConvNeXt writes it, inference only;
    ``clip(name, x)`` is applied to each prunable layer's input."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, DIMS[0], 4, stride=4)
        self.stem_ln = nn.LayerNorm(DIMS[0], eps=1e-6)
        self.ds_ln = nn.ModuleList(nn.LayerNorm(c, eps=1e-6) for c in DIMS[:3])
        self.ds = nn.ModuleList(nn.Conv2d(a, b, 2, stride=2)
                                for a, b in zip(DIMS, DIMS[1:]))
        self.stages = nn.ModuleList(nn.ModuleList(_Block(c) for _ in range(n))
                                    for n, c in zip(DEPTHS, DIMS))
        self.head_ln = nn.LayerNorm(DIMS[-1], eps=1e-6)
        self.fc = nn.Linear(DIMS[-1], CLASSES)

    def forward(self, x, clip=lambda name, t: t):
        def channels_last(f, t):
            return f(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = channels_last(self.stem_ln, self.stem(clip("stem", x)))
        for i, blocks in enumerate(self.stages):
            if i:
                x = channels_last(self.ds_ln[i - 1], x)
                x = self.ds[i - 1](clip(f"s{i}ds", x))
            for j, block in enumerate(blocks):
                x = block(x, clip, f"s{i}b{j}")
        return self.fc(clip("fc", self.head_ln(x.mean((2, 3)))))


@torch.no_grad()
def _module(params, pruned=None):
    """The module with the benchmark's parameters (HWIO convolutions, the
    1 x 1s' (1, 1, cin, cout) as linear weights), ``pruned`` weights in
    place of their layers'."""
    m = _ConvNeXtT()
    w = {n: (pruned or {}).get(n, p.get("w")) for n, p in params.items()}

    def conv(mod, n):
        mod.weight.copy_(w[n].permute(3, 2, 0, 1))
        mod.bias.copy_(params[n]["b"])

    def linear(mod, n):
        mod.weight.copy_(w[n].reshape(w[n].shape[-2:]).T)
        mod.bias.copy_(params[n]["b"])

    def ln(mod, n):
        mod.weight.copy_(params[n]["g"])
        mod.bias.copy_(params[n]["b"])

    conv(m.stem, "stem")
    ln(m.stem_ln, "stem_ln")
    for i in range(1, 4):
        ln(m.ds_ln[i - 1], f"s{i}ds_ln")
        conv(m.ds[i - 1], f"s{i}ds")
    for i, blocks in enumerate(m.stages):
        for j, b in enumerate(blocks):
            tag = f"s{i}b{j}"
            conv(b.dw, f"{tag}dw")
            ln(b.ln, f"{tag}ln")
            linear(b.pw1, f"{tag}pw1")
            linear(b.pw2, f"{tag}pw2")
    ln(m.head_ln, "head_ln")
    linear(m.fc, "fc")
    return m


@pytest.fixture(scope="module")
def built():
    layers = load(ARCH, RES, CLASSES)
    params, images = inputs.make(layers, 7, IMAGES, RES, torch.device("cpu"))
    with torch.no_grad():
        dense = _module(params)(images.permute(0, 3, 1, 2))
    return layers, params, images, dense


def _targets(L):
    """Four seeded proposals: (s_w, s_a), each (4, L) in [0, 0.95)."""
    t = np.random.default_rng(1).uniform(0.0, 0.95, (4, 2 * L))
    return t[:, :L].astype(np.float32), t[:, L:].astype(np.float32)


def _module_zeros(ref, params, images, s_w, s_a):
    """(B, L) zeros of each clipped prunable input in the module, with the
    reference's thresholds (what is compared is the forward they clip)."""
    prunable = ref.prunable
    out = np.zeros(s_w.shape, np.int64)
    for b in range(len(s_w)):
        pruned, taus = {}, {}
        for i, l in enumerate(prunable):
            tau = weight_tau(ref.asort[l.name], s_w[b:b + 1, i])[0]
            w = params[l.name]["w"]
            pruned[l.name] = torch.where(w.abs() >= tau, w, torch.zeros_like(w))
            taus[l.name] = float(act_tau(ref.act_q[l.name], s_a[b:b + 1, i])[0])
        zeros = {}

        def clip(name, x):
            y = torch.where(x.abs() >= taus[name], x, torch.zeros_like(x))
            zeros[name] = int((y == 0).sum())
            return y
        with torch.no_grad():
            _module(params, pruned)(images.permute(0, 3, 1, 2), clip)
        out[b] = [zeros[l.name] for l in prunable]
    return out


def _agree(ref, built):
    """Whether the reference computes the module's network: its dense
    logits within 2^-16 of the largest logit (``BAND``, the rounding band
    the benchmark grants two float32 summation orders; the two run
    ``conv2d`` and ``nn.Linear`` on 1 x 1 products over up to 3,072
    terms, and read about 2e-6 of it apart), and on each of four seeded
    proposals the clipped zero counts equal layer by layer. A count may
    leave the reference's at one layer only within its rounding band (an
    element within BAND of tau falls either way) or by two elements at
    most (at a small s_a, tau is a tiny quantile of a GELU output, and an
    element near it is a pre-activation sum that cancels to near 0, whose
    rounding is not relative to tau); from there the two clipped networks
    differ, and that proposal's later layers are not compared."""
    layers, params, images, dense = built
    tol = BAND * float(ref.dense_logits.abs().max())
    if not float((dense - ref.dense_logits).abs().max()) <= tol:
        return False
    s_w, s_a = _targets(len(ref.prunable))
    r = ref.evaluate(s_w, s_a)
    got = _module_zeros(ref, params, images, s_w, s_a)
    for b in range(len(s_w)):
        for j in range(got.shape[1]):
            if got[b, j] != r["a_zeros"][b, j]:
                lo, hi = r["a_band"][b, j]
                if not (lo <= got[b, j] <= hi or
                        abs(got[b, j] - r["a_zeros"][b, j]) <= 2):
                    return False
                break
    return True


def test_the_table_at_224():
    layers = load(ARCH, 224, CLASSES)
    assert len(layers) == 101
    assert sum(l.prunable for l in layers) == 41
    assert yardstick.network_macs(layers) == 4_455_531_264
    assert [l.name for l in layers if l.prunable][:3] == \
        ["stem", "s0b0pw1", "s0b0pw2"]
    assert [(l.k, l.stride, l.padding, l.out_hw) for l in layers
            if l.name in ("stem", "s1ds", "s2ds", "s3ds")] == \
        [(4, 4, 0, 56), (2, 2, 0, 28), (2, 2, 0, 14), (2, 2, 0, 7)]
    assert {l.act for l in layers if l.name.endswith("pw1")} == {"gelu"}
    assert {l.padding for l in layers if l.kind == "dwconv"} == {3}
    assert sum(l.kind == "ln" for l in layers) == 1 + 3 + 18 + 1
    assert all(l.macs == l.weights == 0 and not l.prunable
               for l in layers if l.kind == "ln")
    assert yardstick.clip_inputs(layers, 1)[:2] == [3 * 224 ** 2,
                                                    96 * 56 ** 2]


def test_hardware_prices_59_stages():
    layers = load(ARCH, 224, CLASSES)
    hw = Hardware(layers, 12234, 600)      # ResNet-18's DSP budget
    assert len(hw.costs) == 59
    L = sum(l.prunable for l in layers)
    m = hw.metrics(np.full(L, 0.5), np.full(L, 0.3))
    assert all(np.isfinite(v) for v in m.values())
    assert m["thr"] > 0 and 0 < m["spa"] < 1


@pytest.mark.parametrize("arch", ["resnet18", "mobilenetv3l", "resnet50"])
@pytest.mark.parametrize("res", [32, 224])
def test_the_existing_tables_pad_by_half_the_kernel(arch, res):
    for l in load(arch, res, CLASSES):
        assert l.pad is None and l.padding == (l.k - 1) // 2


def test_ln_rows_take_nothing_from_the_normal_draw():
    """The weights of a table with LayerNorm rows are those of the same
    table without them: the gains and shifts are made outside the draw, as
    the biases are, so the tables before LayerNorm draw what they drew."""
    layers = load(ARCH, RES, CLASSES)
    bare = [l for l in layers if l.kind != "ln"]
    cpu = torch.device("cpu")
    p, imgs = inputs.make(layers, 11, 2, RES, cpu)
    q, imgs_q = inputs.make(bare, 11, 2, RES, cpu)
    assert torch.equal(imgs, imgs_q)
    assert set(p) - set(q) == {l.name for l in layers if l.kind == "ln"}
    for name, keys in q.items():
        assert p[name].keys() == keys.keys()
        assert all(torch.equal(p[name][k], q[name][k]) for k in keys)
    for l in layers:
        if l.kind == "ln":
            assert torch.equal(p[l.name]["g"], torch.ones(l.cout))
            assert torch.equal(p[l.name]["b"], torch.zeros(l.cout))


def test_the_reference_agrees_with_an_independent_module(built):
    layers, params, images, _ = built
    assert _agree(Reference(layers, params, images), built)


def _ln_skipped(monkeypatch, layers):
    monkeypatch.setattr(Reference, "_layer_norm",
                        staticmethod(lambda x, p: x))
    return layers


def _gelu_tanh(monkeypatch, layers):
    real = forward._act
    monkeypatch.setattr(forward, "_act", lambda x, name: F.gelu(
        x, approximate="tanh") if name == "gelu" else real(x, name))
    return layers


def _stem_padded(monkeypatch, layers):
    return [dataclasses.replace(l, pad=1) if l.name == "stem" else l
            for l in layers]


@pytest.mark.parametrize("fault", [_ln_skipped, _gelu_tanh, _stem_padded],
                         ids=["ln_skipped", "gelu_tanh", "stem_padded_by_1"])
def test_a_planted_fault_breaks_the_agreement(built, fault, monkeypatch):
    layers, params, images, _ = built
    ref = Reference(fault(monkeypatch, layers), params, images)
    assert not _agree(ref, built)


def test_an_unknown_kind_or_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        forward._act(torch.ones(2), "swish")
    odd = [Layer("in", "conv", 3, 8, 3, 2, RES, RES // 2, act="none"),
           Layer("shuffle", "shuffle", 8, 8, in_hw=RES // 2, out_hw=RES // 2)]
    with pytest.raises(ValueError, match="kind"):
        inputs.make(odd, 1, 2, RES, torch.device("cpu"))
    p, imgs = inputs.make(odd[:1], 1, 2, RES, torch.device("cpu"))
    with pytest.raises(ValueError, match="kind"):
        Reference(odd, p, imgs)
    swish = [dataclasses.replace(odd[0], act="swish")]
    with pytest.raises(ValueError, match="activation"):
        Reference(swish, p, imgs)
