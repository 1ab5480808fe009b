"""CUDA graphs whose replays count the kernel launches they hold.

A wrapper called while the current stream captures a graph does not launch
its kernel then: ``kernels._count`` notes the call as captured. A
``CountedGraph`` takes the captured calls of its capture as the launches the
graph holds, and adds them to the launch counts at every replay, so that
``kernels.launch_counts`` stays exact for a path that replays graphs.
"""
from __future__ import annotations

from typing import Callable, Dict

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
        graph's pool, rewritten by every replay). Nothing runs yet."""
        before = dict(kernels._CAPTURED)
        with torch.cuda.graph(self.graph, pool=self.pool):
            out = fn()
        self.held = {k: v - before[k] for k, v in kernels._CAPTURED.items()}
        return out

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.held.items():
            kernels._LAUNCHED[k] += n
