"""ResNet-50 (He et al. 2016, "Deep Residual Learning for Image
Recognition", Table 1, 50-layer): a 7 x 7 stem, a 3 x 3 max pool, four
stages of (3, 4, 6, 3) bottleneck blocks (output widths 256, 512, 1,024,
2,048; each block a 1 x 1 reduce to a quarter of its output width, a 3 x 3
at that width and a 1 x 1 expand back; a 1 x 1 projection where a block
changes width or stride), global average pool, one linear layer.

One departure from the paper: a block that halves the resolution strides
its 3 x 3 convolution, not its first 1 x 1 (torchvision's "v1.5" layout,
4.089 GMAC an image at 224 x 224; the paper's placement gives 3.858, its
Table 1's "3.8 x 10^9"). The program builds this layout, which is that of
the published microsoft/resnet-50 configuration (ResNet v1.5). The
projection strides its 1 x 1, as in the paper."""
from __future__ import annotations

from typing import List

from hassbench.reference.layers import Layer

DEPTHS = (3, 4, 6, 3)
WIDTHS = (256, 512, 1024, 2048)
#: the bottleneck's middle width over its output width
REDUCE = 4


def layers(img_res: int, num_classes: int) -> List[Layer]:
    out: List[Layer] = []
    hw = img_res // 2
    out.append(Layer("stem", "conv", 3, 64, 7, 2, img_res, hw))
    hw //= 2
    out.append(Layer("maxpool", "pool", 64, 64, 3, 2, hw * 2, hw))
    cin, last = 64, "maxpool"
    for stage, (n, w) in enumerate(zip(DEPTHS, WIDTHS)):
        mid = w // REDUCE
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out_hw = hw // stride
            tag = f"s{stage}b{b}"
            block_in = last
            out.append(Layer(f"{tag}c1", "conv", cin, mid, 1, 1, hw, hw))
            out.append(Layer(f"{tag}c2", "conv", mid, mid, 3, stride, hw,
                             out_hw))
            out.append(Layer(f"{tag}c3", "conv", mid, w, 1, 1, out_hw, out_hw,
                             act="none"))
            resid = block_in
            if stride != 1 or cin != w:
                out.append(Layer(f"{tag}proj", "conv", cin, w, 1, stride, hw,
                                 out_hw, act="none", input_from=block_in))
                resid = f"{tag}proj"
            out.append(Layer(f"{tag}add", "add", w, w, in_hw=out_hw,
                             out_hw=out_hw, act="relu",
                             input_from=f"{tag}c3", residual_from=resid))
            cin, hw, last = w, out_hw, f"{tag}add"
    out.append(Layer("gap", "gap", cin, cin, in_hw=hw, out_hw=1))
    out.append(Layer("fc", "linear", cin, num_classes, act="none"))
    return out
