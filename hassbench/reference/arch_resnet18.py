"""ResNet-18 (He et al. 2016, "Deep Residual Learning for Image
Recognition", Table 1, 18-layer): a 7 x 7 stem, a 3 x 3 max pool, four
stages of two basic blocks (64, 128, 256, 512 channels; a 1 x 1 projection
where a block changes width or stride), global average pool, one linear
layer."""
from __future__ import annotations

from typing import List

from hassbench.reference.layers import Layer

DEPTHS = (2, 2, 2, 2)
WIDTHS = (64, 128, 256, 512)


def layers(img_res: int, num_classes: int) -> List[Layer]:
    out: List[Layer] = []
    hw = img_res // 2
    out.append(Layer("stem", "conv", 3, 64, 7, 2, img_res, hw))
    hw //= 2
    out.append(Layer("maxpool", "pool", 64, 64, 3, 2, hw * 2, hw))
    cin, last = 64, "maxpool"
    for stage, (n, w) in enumerate(zip(DEPTHS, WIDTHS)):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out_hw = hw // stride
            tag = f"s{stage}b{b}"
            block_in = last
            out.append(Layer(f"{tag}c1", "conv", cin, w, 3, stride, hw, out_hw))
            out.append(Layer(f"{tag}c2", "conv", w, w, 3, 1, out_hw, out_hw,
                             act="none"))
            resid = block_in
            if stride != 1 or cin != w:
                out.append(Layer(f"{tag}proj", "conv", cin, w, 1, stride, hw,
                                 out_hw, act="none", input_from=block_in))
                resid = f"{tag}proj"
            out.append(Layer(f"{tag}add", "add", w, w, in_hw=out_hw,
                             out_hw=out_hw, act="relu",
                             input_from=f"{tag}c2", residual_from=resid))
            cin, hw, last = w, out_hw, f"{tag}add"
    out.append(Layer("gap", "gap", cin, cin, in_hw=hw, out_hw=1))
    out.append(Layer("fc", "linear", cin, num_classes, act="none"))
    return out
