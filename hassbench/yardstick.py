"""The benchmark's fixed arithmetic: the card's data-sheet peaks, the union
of device intervals, the bound of the clip kernel and the operation count
of a network. Frozen here, beside the reference, so that a change to the
program cannot move the yardstick it is measured with."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from hassbench.reference.layers import Layer

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals covered by ``spans`` (start, end), in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``spans``: the time in which at least one
    device operation ran."""
    return sum(b - a for a, b in union(spans))


def gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    out, t = [], lo
    for a, b in union(spans):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def clip_inputs(layers: Sequence[Layer], images: int) -> List[int]:
    """Elements of each prunable layer's input for ``images`` images (one
    proposal): what one clip launch reads per proposal."""
    return [images * l.cin * (l.in_hw ** 2 if l.kind == "conv" else 1)
            for l in layers if l.prunable]


def clip_bound_s(elements: int, proposals: int, elem_size: int = 4) -> float:
    """The least time of one batched clip launch over ``elements`` per
    proposal: x read once, the clipped activation written once and one
    int32 count per proposal over the memory rate, or one compare per
    element at the float32 rate, whichever is longer."""
    n = elements * proposals
    t_bytes = (2 * n * elem_size + 4 * proposals) / HBM_BYTES_PER_S
    return max(t_bytes, n / FP32_FLOPS)


def network_macs(layers: Sequence[Layer]) -> int:
    """Multiply-accumulates of one dense forward of one image."""
    return sum(l.macs for l in layers)


def forward_flops(layers: Sequence[Layer], images: int, proposals: int) -> float:
    """Operations of ``proposals`` dense forwards over ``images`` images,
    two per multiply-accumulate."""
    return 2.0 * network_macs(layers) * images * proposals

