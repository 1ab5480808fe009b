"""The SPE kernels of the paper, written by hand in CUDA C++ for Hopper.

``act_clip``            clip unit + zero counter   (csrc/act_clip_count.cu)
``block_sparse_matmul`` static tile-schedule matmul (csrc/block_sparse_matmul.cu)
``ref``                 the plain PyTorch version of each
``ops``                 any-shape wrappers (schedule and work-plan construction)
``build``               nvcc build + ctypes loader
``graph``               CUDA graphs whose replays count their launches

A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version only for a tensor that lies on the CPU. Each kernel entry has
a launch count here, which grows by one per wrapper call that launches it
(``_count``); a call captured into a CUDA graph counts at each replay of the
graph (``graph.CountedGraph``), not when it is captured.
"""
from __future__ import annotations

from typing import Dict

import torch

#: per kernel entry: wrapper calls that launched it, and wrapper calls made
#: while the current stream captured a CUDA graph
_LAUNCHED = {"act_clip_count": 0, "act_clip_count_batched": 0,
             "block_sparse_matmul": 0}
_CAPTURED = dict.fromkeys(_LAUNCHED, 0)


def _count(name: str) -> None:
    """Called by a wrapper right after it launched (or, under capture,
    recorded) its kernel."""
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[name] += 1
    else:
        _LAUNCHED[name] += 1


def launch_counts() -> Dict[str, int]:
    """Wrapper calls that launched each kernel entry. One call of either
    ``act_clip_count`` entry is two device operations (a 4-byte memset of
    its ticket word, then the kernel); one ``block_sparse_matmul`` call is
    one launch, or two when its work plan splits K (the product, then the
    ordered reduction)."""
    return dict(_LAUNCHED)


def reset_launch_counts() -> None:
    for k in _LAUNCHED:
        _LAUNCHED[k] = 0
