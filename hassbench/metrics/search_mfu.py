"""The whole search's share of the card's float32 peak: the operations of
the dense forwards of every proposal evaluated (2 per multiply-accumulate,
over the calibration images) over the seconds they took and the data
sheet's 67 TFLOP/s outside the tensor cores (the evaluator computes in
float32 with TF32 off). The count is of the dense network: the device pass
computes every pruned weight's product.

Read over the traced window's searches that neither the profiler nor a
flight recorder touched (``Window.untraced_from`` on), from the first of
them's start to the window's end: those would read the share low."""
from hassbench import yardstick

UNIT = "%"
LAYER = "model step"
MOVES = "trials_per_s"


def read(view):
    w = view.window
    k0 = w.untraced_from
    trials = sum(len(r.xs) for r in w.rounds if r.search >= k0)
    if not trials:
        return None
    flops = yardstick.forward_flops(view.layers,
                                    view.cell.config["calib_images"], trials)
    return 100.0 * flops / (w.t_end - w.search_t0[k0]) / yardstick.FP32_FLOPS
