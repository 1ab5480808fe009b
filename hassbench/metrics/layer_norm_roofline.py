"""Share of its roofline that the model step's LayerNorms reach: the least
time of one pass's LayerNorms over their measured device time a pass.

The least time: each ``ln`` row of the table reads its input once and
writes its output once, ``2 * 4 * images * B * cout * out_hw ** 2`` bytes
in float32 over the memory rate, or one operation per element at the
float32 rate where that is longer (as ``yardstick.clip_bound_s`` bounds
the clip), summed over the rows. The measured time: the device time of
the LayerNorm operations in the profiled search over its rounds, one
batched pass each."""
from hassbench import yardstick

UNIT = "%"
LAYER = "model step"
MOVES = "trials_per_s"
#: PyTorch's CUDA LayerNorm forward kernel, as the card's trace named it
#: (``at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float,
#: float, false>``, the only LayerNorm kernel in the traced runs of
#: ``convnext_t.search.b8`` on an H100 80GB HBM3 with torch 2.11.0+cu128)
KERNELS = ("vectorized_layer_norm_kernel",)


def bound_s(layers, images: int, proposals: int) -> float:
    """The least time of one pass's LayerNorms."""
    total = 0.0
    for l in layers:
        if l.kind == "ln":
            n = images * proposals * l.cout * l.out_hw ** 2
            total += max(2 * 4 * n / yardstick.HBM_BYTES_PER_S,
                         n / yardstick.FP32_FLOPS)
    return total


def read(view):
    prof = view.profile
    if prof is None:
        return None
    spent = sum(s for name, (s, _) in prof["kernels"].items()
                if any(k in name for k in KERNELS))
    rounds = sum(1 for r in view.window.rounds if r.search == 0)
    if not spent or not rounds:
        return None
    B = view.cell.traffic["batch_size"] or 1
    bound = bound_s(view.layers, view.cell.config["calib_images"], B)
    return 100.0 * bound / (spent / rounds)
