"""The device an entry point runs on: the card unless the caller asks for the
CPU, and never a silent move to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device to run on. ``"cuda"`` needs a card: there is no silent
    move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the host on purpose")
        # a float32 convolution or product is TF32 by default on the card;
        # a float32 result here means float32 arithmetic, so both are off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
