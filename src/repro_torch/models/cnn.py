"""The paper's benchmark CNNs: ResNet-18/50, MobileNetV2, MobileNetV3-S/L,
and ConvNeXt-T, a LayerNorm / GELU ConvNet of ResNet-50's class.

Models are described as an explicit dataflow list of ``LayerSpec``s and
executed by a small interpreter, so the HASS search and the DSE consume
*exactly* the layers the forward pass runs (the paper's Fig. 4 ResNet-18
workload is the 16 3x3 convs this spec produces — matching the paper's count).
BatchNorm is folded into conv bias (standard for FPGA deployment flows;
fpgaConvNet folds BN as well). An ``ln`` layer is a LayerNorm over each
pixel's channels (or a pooled row's features) with gain ``g`` and shift
``b``. A convolution pads ``pad`` pixels on every side, ``(k - 1) // 2``
where the spec gives none.

Each spec names its input: ``input_from=None`` means "previous layer output";
``add`` layers sum their sequential input with ``residual_from``'s output.
This mirrors the dataflow-graph view of Fig. 3 (left) in the paper.

Layouts at the public boundary are those of the JAX package: images and every
layer output NHWC, convolution weights HWIO ``(k, k, cin, cout)`` (depthwise
``(k, k, 1, cout)``), linear weights ``(cin, cout)``. The convolutions
run on channels-first *views* of those tensors, but for the batched
forward's over more than one proposal, which run on the NHWC tensors
themselves: a 1 x 1 stride-1 layer as a product (``_conv_gemm``), any
other ``conv`` layer as the implicit-GEMM kernel (``ops.conv_igemm``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import act_clip, dense_init, softmax_xent

INPUT = "__input__"
#: the eps of every LayerNorm: ConvNeXt's, which facebookresearch/ConvNeXt
#: ``models/convnext.py`` sets to 1e-6 for the stem's, the downsampling
#: layers', each block's and the head's
LN_EPS = 1e-6


@dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str                 # conv | dwconv | linear | pool | gap | add | se | ln
    cin: int = 0
    cout: int = 0
    k: int = 1
    stride: int = 1
    in_hw: int = 0
    out_hw: int = 0
    act: str = "relu"         # relu | hswish | gelu (exact, erf) | none
    input_from: Optional[str] = None
    residual_from: Optional[str] = None
    se_ratio: float = 0.0
    pad: Optional[int] = None

    @property
    def padding(self) -> int:
        """Pixels a convolution pads on each side: ``pad``, or
        ``(k - 1) // 2`` where the spec gives none."""
        return (self.k - 1) // 2 if self.pad is None else self.pad

    @property
    def macs(self) -> int:
        """MACs per image — the paper's C_l (dense operation count)."""
        if self.kind == "conv":
            return self.cout * self.cin * self.k * self.k * self.out_hw ** 2
        if self.kind == "dwconv":
            return self.cout * self.k * self.k * self.out_hw ** 2
        if self.kind == "linear":
            return self.cin * self.cout
        if self.kind == "se":
            mid = max(8, int(self.cin * self.se_ratio))
            return 2 * self.cin * mid
        return 0

    @property
    def weights(self) -> int:
        if self.kind == "conv":
            return self.cout * self.cin * self.k * self.k
        if self.kind == "dwconv":
            return self.cout * self.k * self.k
        if self.kind == "linear":
            return self.cin * self.cout
        return 0

    @property
    def prunable(self) -> bool:
        # the paper prunes the DSP-heavy multipliers: convs and linears
        return self.kind in ("conv", "linear") and self.weights > 0


# --------------------------------------------------------------------- #
# Spec builders
# --------------------------------------------------------------------- #
def _resnet(depths, widths, bottleneck, res, num_classes) -> List[LayerSpec]:
    specs: List[LayerSpec] = []
    hw = res // 2
    specs.append(LayerSpec("stem", "conv", 3, 64, 7, 2, res, hw))
    hw //= 2
    specs.append(LayerSpec("maxpool", "pool", 64, 64, 3, 2, hw * 2, hw))
    cin, last = 64, "maxpool"
    for stage, (n, w) in enumerate(zip(depths, widths)):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out_hw = hw // stride
            tag = f"s{stage}b{b}"
            block_in = last
            if bottleneck:
                mid = w // 4
                specs.append(LayerSpec(f"{tag}c1", "conv", cin, mid, 1, 1, hw, hw))
                specs.append(LayerSpec(f"{tag}c2", "conv", mid, mid, 3, stride,
                                       hw, out_hw))
                specs.append(LayerSpec(f"{tag}c3", "conv", mid, w, 1, 1,
                                       out_hw, out_hw, act="none"))
                main = f"{tag}c3"
            else:
                specs.append(LayerSpec(f"{tag}c1", "conv", cin, w, 3, stride,
                                       hw, out_hw))
                specs.append(LayerSpec(f"{tag}c2", "conv", w, w, 3, 1,
                                       out_hw, out_hw, act="none"))
                main = f"{tag}c2"
            resid = block_in
            if stride != 1 or cin != w:
                specs.append(LayerSpec(f"{tag}proj", "conv", cin, w, 1, stride,
                                       hw, out_hw, act="none",
                                       input_from=block_in))
                resid = f"{tag}proj"
            specs.append(LayerSpec(f"{tag}add", "add", w, w, in_hw=out_hw,
                                   out_hw=out_hw, act="relu",
                                   input_from=main, residual_from=resid))
            cin, hw, last = w, out_hw, f"{tag}add"
    specs.append(LayerSpec("gap", "gap", cin, cin, in_hw=hw, out_hw=1))
    specs.append(LayerSpec("fc", "linear", cin, num_classes, act="none"))
    return specs


def _mbv2(res, num_classes) -> List[LayerSpec]:
    setting = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    specs: List[LayerSpec] = []
    hw = res // 2
    specs.append(LayerSpec("stem", "conv", 3, 32, 3, 2, res, hw))
    cin, last, bid = 32, "stem", 0
    for t, c, n, s in setting:
        for b in range(n):
            stride = s if b == 0 else 1
            out_hw = hw // stride
            mid = cin * t
            tag = f"b{bid}"
            block_in = last
            if t != 1:
                specs.append(LayerSpec(f"{tag}exp", "conv", cin, mid, 1, 1, hw, hw))
            specs.append(LayerSpec(f"{tag}dw", "dwconv", mid, mid, 3, stride,
                                   hw, out_hw))
            specs.append(LayerSpec(f"{tag}prj", "conv", mid, c, 1, 1,
                                   out_hw, out_hw, act="none"))
            last = f"{tag}prj"
            if stride == 1 and cin == c:
                specs.append(LayerSpec(f"{tag}add", "add", c, c, in_hw=out_hw,
                                       out_hw=out_hw, act="none",
                                       input_from=last, residual_from=block_in))
                last = f"{tag}add"
            cin, hw, bid = c, out_hw, bid + 1
    specs.append(LayerSpec("head", "conv", cin, 1280, 1, 1, hw, hw))
    specs.append(LayerSpec("gap", "gap", 1280, 1280, in_hw=hw, out_hw=1))
    specs.append(LayerSpec("fc", "linear", 1280, num_classes, act="none"))
    return specs


def _mbv3(small, res, num_classes) -> List[LayerSpec]:
    if small:
        setting = [(3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
                   (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hswish", 2),
                   (5, 240, 40, True, "hswish", 1), (5, 240, 40, True, "hswish", 1),
                   (5, 120, 48, True, "hswish", 1), (5, 144, 48, True, "hswish", 1),
                   (5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1),
                   (5, 576, 96, True, "hswish", 1)]
        head, fc_mid = 576, 1024
    else:
        setting = [(3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
                   (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
                   (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
                   (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
                   (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
                   (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
                   (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
                   (5, 960, 160, True, "hswish", 1)]
        head, fc_mid = 960, 1280
    specs: List[LayerSpec] = []
    hw = res // 2
    specs.append(LayerSpec("stem", "conv", 3, 16, 3, 2, res, hw, act="hswish"))
    cin, last = 16, "stem"
    for bid, (k, exp, c, se, act, s) in enumerate(setting):
        out_hw = hw // s
        tag = f"b{bid}"
        block_in = last
        if exp != cin:
            specs.append(LayerSpec(f"{tag}exp", "conv", cin, exp, 1, 1, hw, hw,
                                   act=act))
        specs.append(LayerSpec(f"{tag}dw", "dwconv", exp, exp, k, s, hw, out_hw,
                               act=act))
        if se:
            specs.append(LayerSpec(f"{tag}se", "se", exp, exp, in_hw=out_hw,
                                   out_hw=out_hw, se_ratio=0.25))
        specs.append(LayerSpec(f"{tag}prj", "conv", exp, c, 1, 1, out_hw, out_hw,
                               act="none"))
        last = f"{tag}prj"
        if s == 1 and cin == c:
            specs.append(LayerSpec(f"{tag}add", "add", c, c, in_hw=out_hw,
                                   out_hw=out_hw, act="none",
                                   input_from=last, residual_from=block_in))
            last = f"{tag}add"
        cin, hw = c, out_hw
    specs.append(LayerSpec("head", "conv", cin, head, 1, 1, hw, hw, act="hswish"))
    specs.append(LayerSpec("gap", "gap", head, head, in_hw=hw, out_hw=1))
    specs.append(LayerSpec("fc2", "linear", head, fc_mid, act="hswish"))
    specs.append(LayerSpec("fc", "linear", fc_mid, num_classes, act="none"))
    return specs


def _convnext(res, num_classes) -> List[LayerSpec]:
    """ConvNeXt-T (Liu et al. 2022, arXiv:2201.03545; facebookresearch/
    ConvNeXt ``models/convnext.py``): a 4 x 4 stride-4 patchify stem with
    no padding and a LayerNorm; stages of (3, 3, 9, 3) blocks at widths
    (96, 192, 384, 768), each stage after the first entered through a
    LayerNorm and a 2 x 2 stride-2 convolution with no padding; each block
    a 7 x 7 depthwise convolution, a LayerNorm, a 1 x 1 to four times the
    width with the exact GELU, a 1 x 1 back (the layer scale folded into
    its weights and bias) and the residual add; global pool, LayerNorm,
    classifier. The official code's pointwise ``nn.Linear`` layers are 1 x
    1 convolutions here: the same products."""
    depths, widths = (3, 3, 9, 3), (96, 192, 384, 768)
    specs: List[LayerSpec] = []
    hw, cin = res // 4, widths[0]
    specs.append(LayerSpec("stem", "conv", 3, cin, 4, 4, res, hw, act="none",
                           pad=0))
    specs.append(LayerSpec("stem_ln", "ln", cin, cin, in_hw=hw, out_hw=hw,
                           act="none"))
    last = "stem_ln"
    for stage, (n, c) in enumerate(zip(depths, widths)):
        if stage:
            specs.append(LayerSpec(f"s{stage}ds_ln", "ln", cin, cin,
                                   in_hw=hw, out_hw=hw, act="none"))
            specs.append(LayerSpec(f"s{stage}ds", "conv", cin, c, 2, 2, hw,
                                   hw // 2, act="none", pad=0))
            hw //= 2
            last = f"s{stage}ds"
        for b in range(n):
            tag = f"s{stage}b{b}"
            block_in = last
            specs.append(LayerSpec(f"{tag}dw", "dwconv", c, c, 7, 1, hw, hw,
                                   act="none"))
            specs.append(LayerSpec(f"{tag}ln", "ln", c, c, in_hw=hw,
                                   out_hw=hw, act="none"))
            specs.append(LayerSpec(f"{tag}pw1", "conv", c, 4 * c, 1, 1, hw,
                                   hw, act="gelu"))
            specs.append(LayerSpec(f"{tag}pw2", "conv", 4 * c, c, 1, 1, hw,
                                   hw, act="none"))
            specs.append(LayerSpec(f"{tag}add", "add", c, c, in_hw=hw,
                                   out_hw=hw, act="none",
                                   input_from=f"{tag}pw2",
                                   residual_from=block_in))
            last = f"{tag}add"
        cin = c
    specs.append(LayerSpec("gap", "gap", cin, cin, in_hw=hw, out_hw=1))
    specs.append(LayerSpec("head_ln", "ln", cin, cin, in_hw=1, out_hw=1,
                           act="none"))
    specs.append(LayerSpec("fc", "linear", cin, num_classes, act="none"))
    return specs


def build_specs(cfg: ModelConfig) -> List[LayerSpec]:
    r, nc = cfg.img_res, cfg.num_classes
    if cfg.cnn_arch == "resnet18":
        return _resnet([2, 2, 2, 2], [64, 128, 256, 512], False, r, nc)
    if cfg.cnn_arch == "resnet50":
        return _resnet([3, 4, 6, 3], [256, 512, 1024, 2048], True, r, nc)
    if cfg.cnn_arch == "mobilenetv2":
        return _mbv2(r, nc)
    if cfg.cnn_arch == "mobilenetv3s":
        return _mbv3(True, r, nc)
    if cfg.cnn_arch == "mobilenetv3l":
        return _mbv3(False, r, nc)
    if cfg.cnn_arch == "convnext_t":
        return _convnext(r, nc)
    raise ValueError(cfg.cnn_arch)


# --------------------------------------------------------------------- #
# Interpreter
# --------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random parameters drawn from ``gen`` (one seed -> one model), placed
    on ``device``: the card, unless the caller asks for ``"cpu"``."""
    specs = build_specs(cfg)
    params = {}

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    for s in specs:
        if s.kind == "conv":
            params[s.name] = {
                "w": dense_init(gen, (s.k, s.k, s.cin, s.cout), in_axis=-2,
                                scale=1.0 / s.k, device=device),
                "b": zeros(s.cout)}
        elif s.kind == "dwconv":
            params[s.name] = {
                "w": dense_init(gen, (s.k, s.k, 1, s.cout), in_axis=-1,
                                scale=1.0 / s.k, device=device),
                "b": zeros(s.cout)}
        elif s.kind == "linear":
            params[s.name] = {"w": dense_init(gen, (s.cin, s.cout),
                                              device=device),
                              "b": zeros(s.cout)}
        elif s.kind == "se":
            mid = max(8, int(s.cin * s.se_ratio))
            params[s.name] = {"w1": dense_init(gen, (s.cin, mid),
                                               device=device),
                              "b1": zeros(mid),
                              "w2": dense_init(gen, (mid, s.cin),
                                               device=device),
                              "b2": zeros(s.cin)}
        elif s.kind == "ln":
            params[s.name] = {
                "g": torch.ones((s.cout,), dtype=torch.float32,
                                device=device),
                "b": zeros(s.cout)}
    return params


def _act(x, name):
    if name == "relu":
        return F.relu(x)
    if name == "hswish":
        return F.hardswish(x)
    if name == "gelu":
        return F.gelu(x)            # the exact, erf form
    if name == "none":
        return x
    raise ValueError(f"unknown activation {name!r}")


def _layer_norm(x, p, C: int):
    """LayerNorm over each run of ``C`` channels of x's last dim (one
    proposal's channels of a pixel, or of a pooled row), with the gain
    ``p["g"]`` and shift ``p["b"]`` of C each: one launch for all of them,
    over a ``(..., B, C)`` view, no copy. Counted as ``layer_norm`` in
    ``kernels.product_counts``."""
    y = F.layer_norm(x.reshape(x.shape[:-1] + (-1, C)), (C,), p["g"],
                     p["b"], LN_EPS)
    kernels._count("layer_norm", x.is_cuda)
    return y.reshape(x.shape)


def _same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" split for one spatial dim: the total padding that makes
    the output ``ceil(size / stride)`` long, the smaller half first. For a
    3x3 stride-2 window on an even size that is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int, pad: int, groups: int):
    """NHWC x, HWIO w -> NHWC, through channels-first views (no copy of x:
    a contiguous NHWC tensor *is* a channels-last NCHW tensor)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def is_gemm(s: LayerSpec, groups: int) -> bool:
    """A convolution that ``forward_batched`` runs through ``_conv_gemm``:
    1 x 1, stride 1, over more than one proposal. On the card the
    product of one group sums the deep layers with a wide cin (M = N * H
    * W of 392 or 1,568, cin 480 to 2,048) in another order than the cuDNN
    convolution of one proposal, which the set-up's dense forward (the
    clip thresholds' quantiles) and the shape-1 program keep; over B = 8
    groups it gives that convolution's result bit for bit, on every
    layer of ResNet-50 and MobileNetV3-L."""
    return s.kind == "conv" and s.k == 1 and s.stride == 1 and groups > 1


def is_igemm(s: LayerSpec, groups: int) -> bool:
    """A convolution that ``forward_batched`` runs through
    ``ops.conv_igemm``: every ``conv`` layer over more than one proposal
    that ``is_gemm`` leaves (the 3 x 3s, the strided 1 x 1 projections,
    the stems, ConvNeXt-T's unpadded 4 x 4 stride-4 stem and 2 x 2
    stride-2 downsampling layers). One proposal stays on cuDNN, for the
    reason ``is_gemm`` gives; the depthwise layers stay on cuDNN too."""
    return s.kind == "conv" and groups > 1 and not is_gemm(s, groups)


def _conv_gemm(x, w):
    """A 1 x 1 stride-1 convolution of B groups as one strided-batched
    product: NHWC x (N, H, W, B * cin), w (B, cin, cout) -> NHWC (N, H, W,
    B * cout). Over the M = N * H * W pixels, group b reads the (M, cin)
    view of x at column b * cin (row stride B * cin) and writes the (M,
    cout) view of the output at column b * cout (row stride B * cout): the
    product writes the NHWC output in place, with no transpose and no copy
    of x, w or y (an ``out=`` product has no backward: the batched forward
    runs without autograd). Counted as ``conv_gemm`` in
    ``kernels.product_counts``."""
    B, cin, cout = w.shape
    y = x.new_empty(x.shape[:-1] + (B * cout,))
    torch.bmm(x.reshape(-1, B, cin).transpose(0, 1), w,
              out=y.view(-1, B, cout).transpose(0, 1))
    kernels._count("conv_gemm", x.is_cuda)
    return y


def forward(cfg: ModelConfig, params, images, *, sparsity=None,
            collect_stats=False, return_intermediates=False):
    """images: (B, H, W, 3). sparsity: {layer_name: tau_a}.

    Returns logits, or (logits, stats) with per-prunable-layer input zero
    fraction when collect_stats (feeds the paper's calibration pass), or
    (logits, outs) with every layer output when return_intermediates.
    The stats forward is ``forward_batched`` over one proposal: ``params``'
    own weights, a prunable layer without a tau clipped at 0 (which counts
    the zeros already there).
    """
    if collect_stats and not return_intermediates:
        weights, taus = {}, {}
        for s in build_specs(cfg):
            tau = sparsity.get(s.name) if sparsity else None
            if s.prunable:
                weights[s.name] = params[s.name]["w"][None]
            if s.prunable or tau is not None:
                taus[s.name] = torch.as_tensor(
                    0.0 if tau is None else tau,
                    dtype=torch.float32).reshape(1).to(images.device)
        logits, stats = forward_batched(cfg, params, weights, images, taus)
        return logits[:, 0], {n: v[0] for n, v in stats.items()}
    specs = build_specs(cfg)
    outs: Dict[str, torch.Tensor] = {INPUT: images.to(torch.float32)}
    last = INPUT
    for s in specs:
        x = outs[s.input_from or last]
        tau = sparsity.get(s.name) if sparsity else None
        if s.kind in ("conv", "dwconv"):
            x = act_clip(x, tau)
            p = params[s.name]
            groups = s.cout if s.kind == "dwconv" else 1
            x = _conv(x, p["w"], s.stride, s.padding, groups)
            x = _act(x + p["b"], s.act)
        elif s.kind == "pool":
            (t, b), (l, r) = (_same_pads(x.shape[1], s.k, s.stride),
                              _same_pads(x.shape[2], s.k, s.stride))
            xp = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b),
                       value=float("-inf"))
            x = F.max_pool2d(xp, s.k, s.stride).permute(0, 2, 3, 1) \
                .contiguous()
        elif s.kind == "gap":
            x = x.mean(dim=(1, 2))
        elif s.kind == "linear":
            x = act_clip(x, tau)
            p = params[s.name]
            x = _act(x @ p["w"] + p["b"], s.act)
        elif s.kind == "se":
            p = params[s.name]
            z = x.mean(dim=(1, 2))
            z = F.relu(z @ p["w1"] + p["b1"])
            z = torch.sigmoid(z @ p["w2"] + p["b2"])
            x = x * z[:, None, None, :]
        elif s.kind == "add":
            x = _act(x + outs[s.residual_from], s.act)
        elif s.kind == "ln":
            x = _act(_layer_norm(x, params[s.name], s.cout), s.act)
        else:
            raise ValueError(f"unknown layer kind {s.kind!r} ({s.name})")
        outs[s.name] = x
        last = s.name
    logits = outs[last]
    return (logits, outs) if return_intermediates else logits


def forward_batched(cfg: ModelConfig, params, weights, images, taus):
    """The clipped stats forward of B proposals at once (the JAX package's
    ``forward(..., collect_stats=True)`` under ``vmap``).

    ``weights`` maps every prunable layer to its B pruned weights stacked on
    a leading axis (the rest of ``params`` is shared), ``taus`` to its (B,)
    float32 clip thresholds on the images' device (a tau for a layer that
    is not prunable clips its input without counting). Every activation
    holds the B proposals' channels side by side in its last dim, NHWC with
    B * C channels: where B > 1 a 1 x 1 stride-1 convolution is one
    strided-batched product on those channels (``_conv_gemm``,
    ``is_gemm``) and any other ``conv`` one launch of the implicit-GEMM
    kernel over the B groups, its bias and relu in the kernel
    (``ops.conv_igemm``, ``is_igemm``); every other convolution is one
    grouped convolution (``groups=B``, B * cout for ``dwconv``), a linear
    layer one batched product, a LayerNorm one launch over each
    proposal's C channels (``_layer_norm``), SE, pooling and
    residual adds act per channel and so per proposal, and a
    prunable layer's clip and zero count is one ``ops.act_clip_batched``
    call. Returns (logits (N, B, classes), {layer: (B,) input zero
    fraction}).
    """
    B = next(iter(taus.values())).numel()
    specs = build_specs(cfg)
    x = images.to(torch.float32)
    outs: Dict[str, torch.Tensor] = {INPUT: x.repeat(1, 1, 1, B)}
    stats: Dict[str, torch.Tensor] = {}
    last = INPUT
    for s in specs:
        x = outs[s.input_from or last]
        p = params.get(s.name)
        if s.prunable:
            x, cnt = ops.act_clip_batched(x, taus[s.name])
            stats[s.name] = cnt.to(torch.float32) / (x.numel() // B)
        elif s.name in taus:
            x = act_clip(x, taus[s.name].repeat_interleave(x.shape[-1] // B))
        if is_igemm(s, B):
            relu = s.act == "relu"
            x = ops.conv_igemm(x, weights[s.name].contiguous(), p["b"],
                               s.stride, relu, s.padding)
            if not relu:
                x = _act(x, s.act)
        elif s.kind in ("conv", "dwconv"):
            if is_gemm(s, B):
                x = _conv_gemm(x, weights[s.name].reshape(B, s.cin, s.cout))
            else:
                if s.kind == "conv":    # one proposal: its HWIO weight
                    w, groups = weights[s.name][0], 1
                else:
                    w = p["w"].repeat(1, 1, 1, B)
                    groups = B * s.cout
                x = _conv(x, w, s.stride, s.padding, groups)
            x = _act(x + p["b"].repeat(B), s.act)
        elif s.kind == "pool":
            (t, b), (l, r) = (_same_pads(x.shape[1], s.k, s.stride),
                              _same_pads(x.shape[2], s.k, s.stride))
            xp = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b),
                       value=float("-inf"))
            x = F.max_pool2d(xp, s.k, s.stride).permute(0, 2, 3, 1) \
                .contiguous()
        elif s.kind == "gap":
            x = x.mean(dim=(1, 2))
        elif s.kind == "linear":           # (N, B * cin) -> (B, N, cin)
            xb = x.reshape(-1, B, s.cin).transpose(0, 1)
            y = _act(torch.bmm(xb, weights[s.name]) + p["b"], s.act)
            x = y.transpose(0, 1).reshape(-1, B * s.cout)
        elif s.kind == "se":
            z = x.mean(dim=(1, 2)).reshape(-1, B, s.cin)
            z = F.relu(z @ p["w1"] + p["b1"])
            z = torch.sigmoid(z @ p["w2"] + p["b2"]).reshape(-1, B * s.cin)
            x = x * z[:, None, None, :]
        elif s.kind == "add":
            x = _act(x + outs[s.residual_from], s.act)
        elif s.kind == "ln":            # each proposal's C channels
            x = _act(_layer_norm(x, p, s.cout), s.act)
        else:
            raise ValueError(f"unknown layer kind {s.kind!r} ({s.name})")
        outs[s.name] = x
        last = s.name
    logits = outs[last]
    return logits.reshape(logits.shape[0], B, -1), stats


def loss(cfg: ModelConfig, params, batch, *, sparsity=None, remat=None):
    logits = forward(cfg, params, batch["images"], sparsity=sparsity)
    l = softmax_xent(logits, batch["labels"]).mean()
    return l, {"xent": l}
