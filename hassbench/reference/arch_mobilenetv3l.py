"""MobileNetV3-Large 1.0 (Howard et al. 2019, "Searching for MobileNetV3",
Table 1): a 3 x 3 hswish stem, fifteen inverted-residual blocks (expansion
1 x 1, depthwise k x k, squeeze-and-excite where the table marks it,
projection 1 x 1; a residual add where stride and width allow), a 1 x 1
head to 960, global average pool, a 1280-wide hswish linear layer and the
classifier."""
from __future__ import annotations

from typing import List

from hassbench.reference.layers import Layer

#: (kernel, expansion width, output width, squeeze-and-excite, activation,
#: stride), Table 1 of the paper
BLOCKS = ((3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
          (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
          (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
          (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
          (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
          (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
          (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
          (5, 960, 160, True, "hswish", 1))
HEAD, FC_MID = 960, 1280


def layers(img_res: int, num_classes: int) -> List[Layer]:
    out: List[Layer] = []
    hw = img_res // 2
    out.append(Layer("stem", "conv", 3, 16, 3, 2, img_res, hw, act="hswish"))
    cin, last = 16, "stem"
    for bid, (k, exp, c, se, act, s) in enumerate(BLOCKS):
        out_hw = hw // s
        tag = f"b{bid}"
        block_in = last
        if exp != cin:
            out.append(Layer(f"{tag}exp", "conv", cin, exp, 1, 1, hw, hw,
                             act=act))
        out.append(Layer(f"{tag}dw", "dwconv", exp, exp, k, s, hw, out_hw,
                         act=act))
        if se:
            out.append(Layer(f"{tag}se", "se", exp, exp, in_hw=out_hw,
                             out_hw=out_hw, se_ratio=0.25))
        out.append(Layer(f"{tag}prj", "conv", exp, c, 1, 1, out_hw, out_hw,
                         act="none"))
        last = f"{tag}prj"
        if s == 1 and cin == c:
            out.append(Layer(f"{tag}add", "add", c, c, in_hw=out_hw,
                             out_hw=out_hw, act="none", input_from=last,
                             residual_from=block_in))
            last = f"{tag}add"
        cin, hw = c, out_hw
    out.append(Layer("head", "conv", cin, HEAD, 1, 1, hw, hw, act="hswish"))
    out.append(Layer("gap", "gap", HEAD, HEAD, in_hw=hw, out_hw=1))
    out.append(Layer("fc2", "linear", HEAD, FC_MID, act="hswish"))
    out.append(Layer("fc", "linear", FC_MID, num_classes, act="none"))
    return out
