"""Share of its roofline that the clip kernel's batched entry reaches: the
least time of a launch (``yardstick.clip_bound_s`` over the cell's clip
inputs, averaged over the prunable layers) over the kernel's mean device
time per launch in the profiled search."""
from hassbench import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "trials_per_s"
KERNEL = "act_clip_count_batched_kernel"


def read(view):
    prof = view.profile
    if prof is None:
        return None
    hits = [(s, n) for name, (s, n) in prof["kernels"].items()
            if KERNEL in name]
    launches = sum(n for _, n in hits)
    if not launches:
        return None
    mean_s = sum(s for s, _ in hits) / launches
    images = view.cell.config["calib_images"]
    B = view.cell.traffic["batch_size"] or 1
    inputs = yardstick.clip_inputs(view.layers, images)
    bound_s = sum(yardstick.clip_bound_s(e, B) for e in inputs) / len(inputs)
    return 100.0 * bound_s / mean_s
