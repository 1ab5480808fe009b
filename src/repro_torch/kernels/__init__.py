"""The SPE kernels of the paper, written by hand in CUDA C++ for Hopper.

``act_clip``            clip unit + zero counter   (csrc/act_clip_count.cu)
``block_sparse_matmul`` static tile-schedule matmul (csrc/block_sparse_matmul.cu)
``ref``                 the plain PyTorch version of each
``ops``                 any-shape wrappers (padding, schedule construction)
``build``               nvcc build + ctypes loader

A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version only for a tensor that lies on the CPU. Each wrapper module
keeps ``launches``, a plain integer that grows by one per kernel launch.
"""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import act_clip, block_sparse_matmul
    return {"act_clip_count": act_clip.launches,
            "block_sparse_matmul": block_sparse_matmul.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import act_clip, block_sparse_matmul
    act_clip.launches = 0
    block_sparse_matmul.launches = 0
