"""What the benchmark hands to the program and to the reference alike: a
network's weights and the calibration images, made on the device from the
run's seed, in a few large draws, in float32 (the type the evaluator
computes in). The program gets them as its ``params`` / ``images``
arguments; it makes none of them."""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from hassbench.reference.layers import Layer


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of a run's ``seed`` (any whole
    number)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *path])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def _shapes(layers: Sequence[Layer]):
    """(layer, key, shape, std) of every weight: He-normal over the fan-in
    (sigmoid's input of a squeeze-and-excite: LeCun). ``pool``, ``gap``,
    ``add`` and ``ln`` rows have none; a row of another kind raises."""
    for l in layers:
        if l.kind == "conv":
            yield l.name, "w", (l.k, l.k, l.cin, l.cout), \
                math.sqrt(2.0 / (l.k * l.k * l.cin))
        elif l.kind == "dwconv":
            yield l.name, "w", (l.k, l.k, 1, l.cout), math.sqrt(2.0 / (l.k * l.k))
        elif l.kind == "linear":
            yield l.name, "w", (l.cin, l.cout), math.sqrt(2.0 / l.cin)
        elif l.kind == "se":
            yield l.name, "w1", (l.cin, l.se_mid), math.sqrt(2.0 / l.cin)
            yield l.name, "w2", (l.se_mid, l.cin), math.sqrt(1.0 / l.se_mid)
        elif l.kind not in ("pool", "gap", "add", "ln"):
            raise ValueError(f"unknown layer kind {l.kind!r} ({l.name})")


def _constants(l: Layer):
    """(key, length, value) of each parameter made outside the normal
    draw: biases 0; a LayerNorm's gain 1 and shift 0, as published."""
    if l.kind in ("conv", "dwconv", "linear"):
        return (("b", l.cout, 0.0),)
    if l.kind == "se":
        return (("b1", l.se_mid, 0.0), ("b2", l.cin, 0.0))
    if l.kind == "ln":
        return (("g", l.cout, 1.0), ("b", l.cout, 0.0))
    return ()


def make(layers: Sequence[Layer], seed: int, images: int, img_res: int,
         device: torch.device) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                        torch.Tensor]:
    """-> (params {layer: {key: tensor}}, images (N, H, W, 3) NHWC): one
    normal draw for all weights and one for the images."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    shapes = list(_shapes(layers))
    total = sum(math.prod(s) for _, _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for name, key, shape, std in shapes:
        n = math.prod(shape)
        params.setdefault(name, {})[key] = \
            flat[at:at + n].view(shape).mul_(std)
        at += n
    for l in layers:
        for key, n, value in _constants(l):
            params.setdefault(l.name, {})[key] = torch.full(
                (n,), value, dtype=torch.float32, device=device)
    gen.manual_seed(sub_seed(seed, 1))
    imgs = torch.randn((images, img_res, img_res, 3), generator=gen,
                       device=device)
    return params, imgs
