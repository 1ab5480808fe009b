"""Grouped convolution as an implicit GEMM: the convolutions of the batched
forward that are no plain product (``models.cnn.is_igemm``), the B
proposals' groups in one launch on the NHWC activations as they lie.

On a CUDA tensor the work is done by the hand-written kernel in
``csrc/conv_igemm.cu``, which reads the B pruned weights as the evaluator
stacks them, ``(B, k, k, cin, cout)``, writes the NHWC output with group b
at column ``b * cout``, and adds the bias and applies the relu in its
epilogue; on a CPU tensor by its plain version in ``ref``, the grouped
convolution the batched forward ran before the kernel. Each launch counts
in ``kernels.launch_counts`` as ``conv_igemm``; a launch made while the
current stream captures a CUDA graph counts at every replay of that graph
instead. A call on the CPU launches nothing and counts nothing.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build, ref

#: the 128-pixel blocks an SM holds at once
_BLOCKS_PER_SM = 4
_FN: list = []
_SMS: dict = {}


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    """An output side: padding ``pad`` on each side of ``size``."""
    return (size + 2 * pad - k) // stride + 1


def tile_m(M: int, cout: int, B: int, sms: int) -> int:
    """Output pixels a block takes (by 64 output channels) for M output
    pixels, cout channels and B groups on a card of ``sms`` SMs: 128 where
    the 128-pixel tiles make two full waves of the card or more, else 64
    (the deep layers, whose few pixels would leave SMs idle)."""
    blocks = -(-M // 128) * -(-cout // 64) * B
    return 128 if blocks >= 2 * _BLOCKS_PER_SM * sms else 64


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, read once per device."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def conv_igemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               stride: int, relu: bool, pad: int) -> torch.Tensor:
    """x: NHWC (N, H, W, B * cin) float32; w: (B, k, k, cin, cout) float32,
    group b's weights in HWIO order; bias: (cout,) float32, shared by the
    groups -> NHWC (N, Ho, Wo, B * cout), group b's outputs at [b * cout,
    (b + 1) * cout): each group's convolution at ``stride`` with padding
    ``pad`` on every side (the layer's ``LayerSpec.padding``), plus the
    bias, then relu if ``relu``. On the card one launch for all B groups,
    each output summed in the order of cuDNN's float32 kernel for that
    layer (channel-major for a 3 x 3 or 2 x 2 layer with cin % 4 == 0,
    tap-major for a stem), so the result is the plain version's on the
    card bit for bit."""
    if x.dim() != 4 or w.dim() != 5 or bias.dim() != 1:
        raise ValueError(f"conv_igemm takes x (N, H, W, B * cin), w (B, k, "
                         f"k, cin, cout) and bias (cout,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(bias.shape)}")
    B, k, k2, cin, cout = w.shape
    if k != k2 or x.shape[-1] != B * cin or bias.numel() != cout:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(bias.shape)} are not one grouped "
                         f"convolution")
    if not x.dtype == w.dtype == bias.dtype == torch.float32:
        raise TypeError("conv_igemm takes float32 tensors")
    if not x.device == w.device == bias.device:
        raise ValueError(f"x, w and bias lie on {x.device}, {w.device}, "
                         f"{bias.device}")
    if not 0 <= pad < k:
        raise ValueError(f"padding {pad} of a {k} x {k} window")
    if x.device.type == "cpu":
        return ref.conv_igemm_ref(x, w, bias, stride, relu, pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv_igemm runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and
            bias.is_contiguous()):
        raise ValueError("conv_igemm needs contiguous tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x holds {x.numel()} elements; the kernel's "
                         f"offsets into it are 32-bit")
    if cout % 4 or w.data_ptr() % 16:
        raise ValueError(f"the kernel copies w in 16-byte runs: cout "
                         f"({cout}) must be a multiple of 4 and w aligned")
    n, H, W, _ = x.shape
    Ho, Wo = out_size(H, k, stride, pad), out_size(W, k, stride, pad)
    y = x.new_empty((n, Ho, Wo, B * cout))
    if not _FN:
        _FN.append(build.lib().hass_conv_igemm_f32)
    with build.device_guard(x):
        err = _FN[0](x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                     y.data_ptr(), n, H, W, cin, cout, k, stride, pad, B,
                     int(relu),
                     tile_m(n * Ho * Wo, cout, B, sm_count(x.device)),
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv_igemm")
    kernels._count("conv_igemm")
    return y
