"""The SPE kernels of the paper, written by hand in CUDA C++ for Hopper.

``act_clip``            clip unit + zero counter   (csrc/act_clip_count.cu)
``block_sparse_matmul`` static tile-schedule matmul (csrc/block_sparse_matmul.cu)
``conv_igemm``          grouped convolution as an implicit GEMM (csrc/conv_igemm.cu)
``ref``                 the plain PyTorch version of each
``ops``                 any-shape wrappers (schedule and work-plan construction)
``build``               nvcc build + ctypes loader
``graph``               CUDA graphs whose replays count their launches

A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version only for a tensor that lies on the CPU. Each kernel entry has
a launch count here, which grows by one per wrapper call that launches it
(``_count``); a call captured into a CUDA graph counts at each replay of the
graph (``graph.CountedGraph``), not when it is captured. The same counts
keep two library products that are no kernel of this package:
``conv_gemm``, a convolution that ``models.cnn`` ran as one
strided-batched product, and ``layer_norm``, one LayerNorm of its model
step (``product_counts``; ``launch_counts`` leaves them out).
"""
from __future__ import annotations

from typing import Dict

import torch

#: per kernel entry: wrapper calls that launched it, and wrapper calls made
#: while the current stream captured a CUDA graph
_LAUNCHED = {"act_clip_count": 0, "act_clip_count_batched": 0,
             "block_sparse_matmul": 0, "conv_gemm": 0, "conv_igemm": 0,
             "layer_norm": 0}
_CAPTURED = dict.fromkeys(_LAUNCHED, 0)
#: the library products among them
_PRODUCTS = ("conv_gemm", "layer_norm")


def _count(name: str, cuda: bool = True) -> None:
    """Called by a wrapper right after it launched (or, under capture,
    recorded) its kernel; ``cuda=False`` for a call that ran on the CPU."""
    if cuda and torch.cuda.is_current_stream_capturing():
        _CAPTURED[name] += 1
    else:
        _LAUNCHED[name] += 1


def launch_counts() -> Dict[str, int]:
    """Wrapper calls that launched each kernel entry. One call of either
    ``act_clip_count`` entry is two device operations (a 4-byte memset of
    its ticket word, then the kernel); one ``block_sparse_matmul`` call is
    one launch, or two when its work plan splits K (the product, then the
    ordered reduction); one ``conv_igemm`` call is one launch."""
    return {k: v for k, v in _LAUNCHED.items() if k not in _PRODUCTS}


def product_counts() -> Dict[str, int]:
    """Calls of each library product counted here, on any device."""
    return {k: _LAUNCHED[k] for k in _PRODUCTS}


def reset_launch_counts() -> None:
    for k in _LAUNCHED:
        _LAUNCHED[k] = 0
