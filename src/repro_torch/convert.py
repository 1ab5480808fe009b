"""Carry parameters between the JAX package and the port.

Both packages keep a model's parameters as a nested dict of arrays under the
same names and in the same layout, so the conversion is array for array:
numpy in, tensors out, and back. That holds for every family: convolution
weights HWIO ``(k, k, cin, cout)`` and linear weights ``(cin, cout)``; the LM
families' per-layer parameters stacked over a leading layer axis (``blocks``,
``enc_blocks``, ``mamba``, the MTP ``block``), MLA's low-rank projections,
MoE experts ``(L, E, d, f)``, Zamba2's one shared block ``(1, ...)``, RWKV's
``blocks`` and whisper's ``enc_pos`` / ``dec_pos``. ``jax.random`` and
``torch.Generator`` never draw the same numbers, so every parity test
initialises in JAX, converts to numpy
(``jax.tree_util.tree_map(np.asarray, params)``) and hands the result to
``params_from_jax``. This module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_bfloat16(a: np.ndarray) -> bool:
    """numpy has no bfloat16; JAX hands one out as ml_dtypes' 2-byte type."""
    return a.dtype.name == "bfloat16"


def params_from_jax(params_numpy: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays (or anything ``np.asarray`` takes) ->
    the same tree of tensors on ``device``; dtypes are kept (bfloat16
    included)."""
    if isinstance(params_numpy, dict):
        return {k: params_from_jax(v, device) for k, v in params_numpy.items()}
    a = np.ascontiguousarray(np.asarray(params_numpy))
    if _is_bfloat16(a):
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_to_jax(params: Any) -> Any:
    """The port's parameter tree -> nested dict of numpy arrays, ready for
    ``jax.numpy.asarray``. A bfloat16 tensor becomes float32 (exactly: every
    bfloat16 is a float32); cast it back on the JAX side."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _is_packed8(x) -> bool:
    """The JAX package's (or the port's) ``Packed8``, known by its
    attributes, so that nothing of the JAX package is imported."""
    return all(hasattr(x, a) for a in ("q", "s", "shape")) and \
        not isinstance(x, (np.ndarray, torch.Tensor))


def train_state_from_jax(state_numpy: Any, device) -> Any:
    """A JAX train state (``init_train_state``'s tree: ``params``, ``opt``
    with ``m`` / ``v`` and ``step``, optionally ``ef``) with its arrays as
    numpy (``jax.tree_util.tree_map(np.asarray, state)``) -> the port's train
    state on ``device``. Moments in float32, bfloat16 or ``Packed8`` keep
    their form; ``opt.step`` is a 0-d int32 tensor."""
    from repro_torch.train.optimizer import Packed8
    if isinstance(state_numpy, dict):
        return {k: train_state_from_jax(v, device)
                for k, v in state_numpy.items()}
    if _is_packed8(state_numpy):
        return Packed8(params_from_jax(state_numpy.q, device),
                       params_from_jax(state_numpy.s, device),
                       state_numpy.shape)
    return params_from_jax(state_numpy, device)


def train_state_to_jax(state: Any) -> Any:
    """The port's train state -> the same tree of numpy arrays. A bfloat16
    tensor becomes float32 (exactly; cast it back on the JAX side), a
    ``Packed8`` a ``Packed8`` of numpy arrays (rebuild the JAX package's
    from its ``q``, ``s`` and ``shape``)."""
    from repro_torch.train.optimizer import Packed8
    if isinstance(state, dict):
        return {k: train_state_to_jax(v) for k, v in state.items()}
    if isinstance(state, Packed8):
        return Packed8(params_to_jax(state.q), params_to_jax(state.s),
                       state.shape)
    return params_to_jax(state)
