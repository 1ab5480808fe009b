"""Carry parameters between the JAX package and the port.

Both packages keep a model's parameters as a nested dict of arrays in the same
layout (convolution weights HWIO ``(k, k, cin, cout)``, linear weights
``(cin, cout)``), so the conversion is array for array: numpy in, tensors out,
and back. ``jax.random`` and ``torch.Generator`` never draw the same numbers,
so every parity test initialises in JAX, converts to numpy
(``jax.tree_util.tree_map(np.asarray, params)``) and hands the result to
``params_from_jax``. This module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(params_numpy: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays (or anything ``np.asarray`` takes) ->
    the same tree of tensors on ``device``; dtypes are kept."""
    if isinstance(params_numpy, dict):
        return {k: params_from_jax(v, device) for k, v in params_numpy.items()}
    a = np.ascontiguousarray(np.asarray(params_numpy))
    return torch.from_numpy(a.copy()).to(device)


def params_to_jax(params: Any) -> Any:
    """The port's parameter tree -> nested dict of numpy arrays, ready for
    ``jax.numpy.asarray``."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
