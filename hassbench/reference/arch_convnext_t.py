"""ConvNeXt-T (Liu et al. 2022, "A ConvNet for the 2020s", arXiv:2201.03545;
facebookresearch/ConvNeXt ``models/convnext.py``; facebook/convnext-tiny-224):
a 4 x 4 stride-4 patchify stem with no padding and a LayerNorm, four stages
of (3, 3, 9, 3) blocks at widths (96, 192, 384, 768), each stage after the
first entered through a LayerNorm and a 2 x 2 stride-2 convolution with no
padding; each block a 7 x 7 depthwise convolution, a LayerNorm, a 1 x 1 to
four times the width with the exact GELU, a 1 x 1 back and the residual
add; then global average pool, a LayerNorm and the classifier. Every
LayerNorm has eps ``LN_EPS``; every convolution and linear layer a bias.

Departures from the official code, each the same function:

* The pointwise layers are 1 x 1 convolutions where the official code has
  ``nn.Linear`` over the channels-last tensor. They are the same products,
  and they put a layer's input count on its pixels, as ``a_numel`` and
  ``yardstick.clip_inputs`` count it.
* The layer scale gamma is folded into the second 1 x 1's weights and
  bias, as BatchNorm is folded into convolution biases throughout; the
  benchmark draws those weights in the folded form, He-normal.
* No drop path: this is inference.
"""
from __future__ import annotations

from typing import List

from hassbench.reference.layers import Layer

DEPTHS = (3, 3, 9, 3)
WIDTHS = (96, 192, 384, 768)
#: the inverted bottleneck's width over the block's
EXPAND = 4


def layers(img_res: int, num_classes: int) -> List[Layer]:
    out: List[Layer] = []
    hw = img_res // 4
    cin = WIDTHS[0]
    out.append(Layer("stem", "conv", 3, cin, 4, 4, img_res, hw, act="none",
                     pad=0))
    out.append(Layer("stem_ln", "ln", cin, cin, in_hw=hw, out_hw=hw,
                     act="none"))
    last = "stem_ln"
    for stage, (n, c) in enumerate(zip(DEPTHS, WIDTHS)):
        if stage:
            out.append(Layer(f"s{stage}ds_ln", "ln", cin, cin, in_hw=hw,
                             out_hw=hw, act="none"))
            out.append(Layer(f"s{stage}ds", "conv", cin, c, 2, 2, hw, hw // 2,
                             act="none", pad=0))
            hw //= 2
            last = f"s{stage}ds"
        for b in range(n):
            tag = f"s{stage}b{b}"
            block_in = last
            out.append(Layer(f"{tag}dw", "dwconv", c, c, 7, 1, hw, hw,
                             act="none"))
            out.append(Layer(f"{tag}ln", "ln", c, c, in_hw=hw, out_hw=hw,
                             act="none"))
            out.append(Layer(f"{tag}pw1", "conv", c, EXPAND * c, 1, 1, hw, hw,
                             act="gelu"))
            out.append(Layer(f"{tag}pw2", "conv", EXPAND * c, c, 1, 1, hw, hw,
                             act="none"))
            out.append(Layer(f"{tag}add", "add", c, c, in_hw=hw, out_hw=hw,
                             act="none", input_from=f"{tag}pw2",
                             residual_from=block_in))
            last = f"{tag}add"
        cin = c
    out.append(Layer("gap", "gap", cin, cin, in_hw=hw, out_hw=1))
    out.append(Layer("head_ln", "ln", cin, cin, in_hw=1, out_hw=1, act="none"))
    out.append(Layer("fc", "linear", cin, num_classes, act="none"))
    return out
