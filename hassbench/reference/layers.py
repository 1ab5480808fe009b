"""The layer table of a CNN, as the reference runs it.

A network is a list of ``Layer`` rows in dataflow order. Each row names its
input (``input_from=None``: the previous row's output); an ``add`` row sums
its input with ``residual_from``'s output; an ``ln`` row is a LayerNorm
over the channels of each pixel (or the features of a pooled row), with
its gain ``g`` and shift ``b``. BatchNorm is folded into the convolution
bias. A convolution pads ``pad`` pixels on each side, ``(k - 1) // 2``
where the row gives none. Activations are NHWC, convolution weights HWIO
``(k, k, cin, cout)`` (depthwise ``(k, k, 1, cout)``), linear weights
``(cin, cout)``.

Each architecture lives in a module of its own, ``arch_<name>.py`` beside
this file, with a function ``layers(img_res, num_classes)``; ``load`` finds
it by the name a configuration file gives.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Optional

INPUT = "__input__"
#: the eps of every LayerNorm: ConvNeXt's, which
#: facebookresearch/ConvNeXt ``models/convnext.py`` sets to 1e-6 for the
#: stem's, the downsampling layers', each block's and the head's
LN_EPS = 1e-6


@dataclass(frozen=True)
class Layer:
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
        ``(k - 1) // 2`` where the row gives none."""
        return (self.k - 1) // 2 if self.pad is None else self.pad

    @property
    def se_mid(self) -> int:
        return max(8, int(self.cin * self.se_ratio))

    @property
    def macs(self) -> int:
        """Multiply-accumulates per image of the dense layer (none for
        ``pool``, ``gap``, ``add`` and ``ln``)."""
        if self.kind == "conv":
            return self.cout * self.cin * self.k * self.k * self.out_hw ** 2
        if self.kind == "dwconv":
            return self.cout * self.k * self.k * self.out_hw ** 2
        if self.kind == "linear":
            return self.cin * self.cout
        if self.kind == "se":
            return 2 * self.cin * self.se_mid
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
        """HASS prunes the multipliers: convolutions and linear layers."""
        return self.kind in ("conv", "linear") and self.weights > 0


def load(arch: str, img_res: int, num_classes: int) -> List[Layer]:
    """The layer table of ``arch`` (``arch_<arch>.py`` beside this file)."""
    mod = importlib.import_module(f"hassbench.reference.arch_{arch}")
    return mod.layers(img_res, num_classes)
