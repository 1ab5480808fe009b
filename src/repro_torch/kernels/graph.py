"""CUDA graphs whose replays count the kernel launches they hold.

A wrapper called while the current stream captures a graph does not launch
its kernel then: ``kernels._count`` notes the call as captured. A
``CountedGraph`` takes the captured calls of its capture as the launches the
graph holds, and adds them to the launch counts at every replay, so that
``kernels.launch_counts`` stays exact for a path that replays graphs.

``warm_and_capture`` is how an owner of graphs builds one: PyTorch's rule of
an eager run on a side stream before the capture. The owners: the evaluator's
batched program, the serving session's decode step, the train step's
``TrainProgram`` and the CNN warm-up's SGD step.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import kernels


class CountedGraph:
    """One ``torch.cuda.CUDAGraph`` captured from ``fn`` into the memory
    pool ``pool`` (shared by the graphs of one owner)."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        #: launches of each kernel entry that one replay makes
        self.held: Dict[str, int] = {}

    def capture(self, fn: Callable):
        """Capture ``fn()`` and return what it returned (tensors of the
        graph's pool, rewritten by every replay). Nothing runs yet. The
        capture is thread-local: another thread of the process may make
        CUDA calls meanwhile (a data pipeline's prefetch thread pins host
        memory while a train step is captured)."""
        before = dict(kernels._CAPTURED)
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = fn()
        self.held = {k: v - before[k] for k, v in kernels._CAPTURED.items()}
        return out

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.held.items():
            kernels._LAUNCHED[k] += n


def warm_and_capture(fn: Callable, pool, device
                     ) -> Tuple[CountedGraph, object, object, int]:
    """Run ``fn()`` once eagerly on a side stream (the libraries and the
    allocator settle; what it returns is the caller's result of this call),
    then capture it into a ``CountedGraph`` in ``pool``. Returns (graph, the
    eager output, the graph's static output, the bytes the pool grew by:
    the allocator's reserved bytes over the capture, its cache emptied
    around it). A failed capture raises: nothing falls back to eager runs."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = CountedGraph(pool)
    static_out = graph.capture(fn)
    torch.cuda.empty_cache()
    return graph, out, static_out, \
        torch.cuda.memory_reserved(device) - reserved
