"""The plain reference of one HASS trial's measurement, in float32.

For a proposal's per-layer targets (s_w, s_a) it prunes each prunable
layer's weight by magnitude at the s_w quantile of |w|, runs the network on
the calibration images with each prunable layer's input clipped at the s_a
quantile of that input's |activation| in the dense run, and reports

* the achieved weight sparsity of each prunable layer (zeros / weights),
* the measured activation sparsity at each prunable layer's input (zeros
  of the clipped input / its elements),
* the logits, and the accuracy proxy: the share of images whose top class
  is the dense network's.

One proposal at a time, with ``torch.nn.functional`` convolutions in NCHW
on whatever device the tensors lie on. It imports nothing of the program:
the quantile and clip arithmetic (float32, the rounding steps written out)
is the paper's one-shot pruning as HASS states it, frozen here.

``precision="tf32"`` is the control: every convolution and product takes
TF32 operands (on the card cuBLAS and cuDNN are allowed TF32; on the CPU,
which has no TF32, the operands are rounded to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from hassbench.reference.layers import INPUT, LN_EPS, Layer

PRECISIONS = ("float32", "tf32")
#: the activation quantile grid of the calibration pass (256 points)
ACT_QUANTILES = np.linspace(0, 0.999, 256)
#: relative half-width of the band around a clip threshold (and around a
#: top-class margin) inside which float32 rounding may put a value on
#: either side in two computations: 256 ulps, more than float32 sums of
#: thousands of terms drift apart in two summation orders
BAND = 2.0 ** -16


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10-bit mantissa (ties to
    even), kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """TF32 allowed in cuBLAS / cuDNN for the block (``tf32`` on the card),
    off otherwise; cuDNN's autotuner off. Restores what it found."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    b = torch.backends
    prev = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark
    on = precision == "tf32" and device.type == "cuda"
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = on
    b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark = prev


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return F.relu(x)
    if name == "hswish":
        return F.hardswish(x)
    if name == "gelu":
        return F.gelu(x)            # the exact, erf form
    if name == "none":
        return x
    raise ValueError(f"unknown activation {name!r}")


def _same_pads(size: int, k: int, stride: int):
    """'SAME' padding of one spatial dim, the smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def weight_tau(asort: torch.Tensor, s_w: np.ndarray) -> torch.Tensor:
    """Magnitude threshold of each target sparsity in ``s_w`` (float32, one
    per proposal) over a layer's sorted |w|: the linear-interpolation
    quantile of the sorted values at ``clamp(s, 0, 1)``, in float32 (scale
    by n - 1, floor and ceil, lerp as ``low * (1 - f) + high * f``); 0 for
    s <= 0."""
    dev = asort.device
    s = torch.as_tensor(np.asarray(s_w, np.float32), device=dev)
    n = torch.full((), asort.numel(), dtype=torch.float32, device=dev)
    q = torch.clamp(s, 0.0, 1.0) * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    fh = q - low
    fl = 1 - fh
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    low = torch.clamp(low, zero, n - 1).to(torch.int64)
    high = torch.clamp(high, zero, n - 1).to(torch.int64)
    tau = asort[low] * fl + asort[high] * fh
    return torch.where(s <= 0.0, torch.zeros_like(tau), tau)


def act_tau(quantiles: np.ndarray, s_a: np.ndarray) -> np.ndarray:
    """Clip threshold of each target activation sparsity: the calibration
    quantile at index ``int(s_a * 256)`` (float32 product, truncated),
    clamped to the grid."""
    nq = len(quantiles)
    idx = (np.asarray(s_a, np.float32) * np.float32(nq)).astype(np.int32)
    return quantiles[np.clip(idx, 0, nq - 1)]


class Reference:
    """The reference network on ``images`` (NHWC float32) with ``params``
    (the benchmark's weights, as handed to the program), at ``precision``.

    Building it runs the dense network once: its top class per image and,
    per prunable layer, 256 quantiles of |input| (``ACT_QUANTILES``, numpy's
    linear method over the float32 values, kept in float32)."""

    def __init__(self, layers: List[Layer], params: Dict, images: torch.Tensor,
                 precision: str = "float32"):
        self.layers = layers
        self.params = params
        self.images = images
        self.precision = precision
        self.device = images.device
        self.prunable = [l for l in layers if l.prunable]
        self.emulate_tf32 = precision == "tf32" and self.device.type != "cuda"
        with torch.no_grad(), _matmul_precision(precision, self.device):
            logits, inputs, _ = self._forward({}, {}, keep_inputs=True)
        self.dense_logits = logits
        self.dense_pred = logits.argmax(-1)
        self.act_q = {
            n: np.quantile(np.abs(x.to("cpu", torch.float32).numpy())
                           .reshape(-1), ACT_QUANTILES).astype(np.float32)
            for n, x in inputs.items()}
        self.asort = {l.name: torch.sort(
            params[l.name]["w"].abs().reshape(-1)).values
            for l in self.prunable}

    # ------------------------------------------------------------------ #
    def _operands(self, *ts):
        return tuple(_round_tf32(t) for t in ts) if self.emulate_tf32 else ts

    def _conv(self, x, w, layer: Layer):
        """NCHW x, HWIO w."""
        groups = layer.cout if layer.kind == "dwconv" else 1
        x, w = self._operands(x, w.permute(3, 2, 0, 1))
        return F.conv2d(x, w, None, stride=layer.stride,
                        padding=layer.padding, groups=groups)

    def _mm(self, x, w):
        x, w = self._operands(x, w)
        return x @ w

    @staticmethod
    def _layer_norm(x, p):
        """Over the channels of each pixel of an NCHW x, or over the
        features of a pooled (N, C) x."""
        if x.dim() == 2:
            return F.layer_norm(x, x.shape[1:], p["g"], p["b"], LN_EPS)
        y = x.permute(0, 2, 3, 1)
        y = F.layer_norm(y, y.shape[3:], p["g"], p["b"], LN_EPS)
        # contiguous NCHW, the layout every other row hands a convolution
        return y.permute(0, 3, 1, 2).contiguous()

    def _forward(self, weights: Dict[str, torch.Tensor],
                 taus: Dict[str, float], keep_inputs: bool = False):
        """-> (logits (N, classes), prunable inputs if asked, zero count of
        each clipped prunable input). ``weights``: pruned weights by layer
        (the layer's own otherwise); ``taus``: clip thresholds (no clip
        where absent)."""
        outs = {INPUT: self.images.to(torch.float32).permute(0, 3, 1, 2)}
        inputs, zeros = {}, {}
        last = INPUT
        for l in self.layers:
            x = outs[l.input_from or last]
            p = self.params.get(l.name)
            if l.prunable:
                if keep_inputs:
                    inputs[l.name] = x
                tau = taus.get(l.name)
                if tau is not None:
                    a = x.abs()
                    zero = x == 0
                    # (zeros, the least and the most that an input within
                    # the rounding band of tau could give)
                    zeros[l.name] = tuple(
                        int((zero | (a < t)).sum()) for t in
                        (tau, tau * (1 - BAND), tau * (1 + BAND)))
                    x = torch.where(a >= tau, x, torch.zeros_like(x))
            if l.kind in ("conv", "dwconv"):
                w = weights.get(l.name, p["w"])
                x = _act(self._conv(x, w, l) + p["b"][None, :, None, None],
                         l.act)
            elif l.kind == "pool":
                (t, b), (lf, r) = (_same_pads(x.shape[2], l.k, l.stride),
                                   _same_pads(x.shape[3], l.k, l.stride))
                x = F.max_pool2d(F.pad(x, (lf, r, t, b), value=float("-inf")),
                                 l.k, l.stride)
            elif l.kind == "gap":
                x = x.mean(dim=(2, 3))
            elif l.kind == "linear":
                w = weights.get(l.name, p["w"])
                x = _act(self._mm(x, w) + p["b"], l.act)
            elif l.kind == "se":
                z = x.mean(dim=(2, 3))
                z = F.relu(self._mm(z, p["w1"]) + p["b1"])
                z = torch.sigmoid(self._mm(z, p["w2"]) + p["b2"])
                x = x * z[:, :, None, None]
            elif l.kind == "add":
                x = _act(x + outs[l.residual_from], l.act)
            elif l.kind == "ln":
                x = _act(self._layer_norm(x, p), l.act)
            else:
                raise ValueError(f"unknown layer kind {l.kind!r} ({l.name})")
            outs[l.name] = x
            last = l.name
        return outs[last], inputs, zeros

    @property
    def w_numel(self) -> np.ndarray:
        """Weights of each prunable layer."""
        return np.array([l.weights for l in self.prunable], np.int64)

    @property
    def a_numel(self) -> np.ndarray:
        """Elements of each prunable layer's input over the images."""
        N = self.images.shape[0]
        return np.array([N * l.cin * (l.in_hw ** 2 if l.kind == "conv" else 1)
                         for l in self.prunable], np.int64)

    @torch.no_grad()
    def evaluate(self, s_w: np.ndarray, s_a: np.ndarray) -> Dict[str, np.ndarray]:
        """(B, L) float32 targets -> ``w_zeros`` and ``a_zeros`` (B, L), the
        zero counts of each pruned weight and clipped input; ``a_band``
        (B, L, 2), the least and the most zeros of a clipped input whose
        elements within ``BAND`` of tau fall either way; ``s_w``,
        ``s_a`` (B, L), those counts over ``w_numel`` / ``a_numel`` in
        float32; ``acc`` (B,) float32; ``logits`` (B, N, classes) float32.
        One proposal at a time."""
        s_w = np.asarray(s_w, np.float32)
        s_a = np.asarray(s_a, np.float32)
        B, L = s_w.shape
        names = [l.name for l in self.prunable]
        tau_w = {n: weight_tau(self.asort[n], s_w[:, i])
                 for i, n in enumerate(names)}
        tau_a = {n: act_tau(self.act_q[n], s_a[:, i])
                 for i, n in enumerate(names)}
        w_zeros = np.zeros((B, L), np.int64)
        a_zeros = np.zeros((B, L), np.int64)
        a_band = np.zeros((B, L, 2), np.int64)
        logits_all, acc = [], np.zeros(B, np.float32)
        N = self.images.shape[0]
        with _matmul_precision(self.precision, self.device):
            for b in range(B):
                weights = {}
                for i, l in enumerate(self.prunable):
                    w = self.params[l.name]["w"]
                    wp = torch.where(w.abs() >= tau_w[l.name][b], w,
                                     torch.zeros_like(w))
                    weights[l.name] = wp
                    w_zeros[b, i] = int((wp == 0).sum())
                taus = {n: float(tau_a[n][b]) for n in names}
                logits, _, zeros = self._forward(weights, taus)
                a_zeros[b] = [zeros[n][0] for n in names]
                a_band[b] = [zeros[n][1:] for n in names]
                agree = int((logits.argmax(-1) == self.dense_pred).sum())
                acc[b] = np.float32(agree) / np.float32(N)
                logits_all.append(logits.to("cpu", torch.float32).numpy())
        return {"w_zeros": w_zeros, "a_zeros": a_zeros, "a_band": a_band,
                "s_w": (w_zeros.astype(np.float32) /
                        self.w_numel.astype(np.float32)),
                "s_a": (a_zeros.astype(np.float32) /
                        self.a_numel.astype(np.float32)),
                "acc": acc, "logits": np.stack(logits_all)}
