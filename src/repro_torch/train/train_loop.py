"""Train-step factory: gradient accumulation, remat, mixed precision.

``make_train_step`` builds the ``(state, batch) -> (state, metrics)`` step of
the JAX package's ``train_loop.py``: gradients of the model's loss with
respect to the float32 master parameters (``torch.autograd.grad``),
accumulated over ``accum`` microbatches in a Python loop (the reference's
``lax.scan``), optionally int8-compressed with error feedback, then one
AdamW update. The update writes into the state's tensors (see
``optimizer``); the state returned holds the same parameter tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import ef_quantize
from repro_torch.models.common import dtype_of
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptConfig, tree_map


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1                     # gradient-accumulation microbatches
    remat: Optional[str] = "full"      # None | "full" | "dots"
    grad_dtype: str = "float32"        # accumulation dtype
    compress_grads: bool = False       # int8 error-feedback numerics
    cast_params_bf16: bool = False     # cast f32 masters to bf16 before use


def _microbatch(batch, accum: int, i: int):
    return tree_map(lambda x: x.reshape((accum, -1) + tuple(x.shape[1:]))[i],
                batch)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A metric as the value every rank agrees on: the pending reduction of
    a ``DTensor`` (a loss over a sharded batch is ``Partial``) is carried
    out, as the reference's step returns its metrics replicated; a plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t.redistribute(placements=[Replicate()] * t.device_mesh.ndim)
    return t


def _value_and_grad(loss_fn, tcfg: TrainConfig, sparsity, params, batch):
    """(loss, metrics, grads) of one batch; the gradients are with respect
    to the master parameters (a parameter the loss does not reach gets
    zeros), whatever dtype the loss computes in."""
    leaves = []

    def track(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        p = tree_map(track, params)
        if tcfg.cast_params_bf16:
            p = tree_map(lambda a: a.to(torch.bfloat16)
                     if a.dtype == torch.float32 else a, p)
        loss, metrics = loss_fn(p, batch, sparsity=sparsity, remat=tcfg.remat)
        gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        g = next(gs)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad_of, params)        # the order in which track ran
    return _replicated(loss.detach()), {
        k: _replicated(torch.as_tensor(v).detach())
        for k, v in metrics.items()}, grads


def compute_grads(loss_fn: Callable, tcfg: TrainConfig, params, batch,
                  sparsity: Optional[Any] = None
                  ) -> Tuple[Any, torch.Tensor, Dict[str, torch.Tensor]]:
    """(grads, loss, metrics) of ``loss_fn(params, batch, *, sparsity,
    remat)``: over the whole batch, or the mean over ``tcfg.accum``
    microbatches (gradients summed in ``tcfg.grad_dtype``, then divided),
    with the last microbatch's metrics, as the reference does."""
    if tcfg.accum <= 1:
        loss, metrics, grads = _value_and_grad(loss_fn, tcfg, sparsity,
                                               params, batch)
        return grads, loss, metrics
    gdt = dtype_of(tcfg.grad_dtype)
    for i in range(tcfg.accum):
        loss, metrics, g = _value_and_grad(loss_fn, tcfg, sparsity, params,
                                           _microbatch(batch, tcfg.accum, i))
        if i == 0:
            # 0 + g is g: the first microbatch's gradients start the sums
            acc, loss_sum = tree_map(lambda a: a.to(gdt), g), loss
        else:
            tree_map(lambda a, b: a.add_(b.to(gdt)), acc, g)
            loss_sum = loss_sum + loss
        del g
    grads = tree_map(lambda a: a / tcfg.accum, acc)
    return grads, loss_sum / tcfg.accum, metrics


def make_train_step(loss_fn: Callable, tcfg: TrainConfig,
                    sparsity: Optional[Any] = None) -> Callable:
    """loss_fn(params, batch, *, sparsity, remat) -> (loss, metrics)."""

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        grads, loss, metrics = compute_grads(loss_fn, tcfg, params, batch,
                                             sparsity)
        out = dict(state)
        if tcfg.compress_grads:
            # int8 error-feedback compression of the gradient payload
            pairs = tree_map(ef_quantize, grads, state["ef"])
            grads = tree_map(lambda pr: pr[0], pairs)
            out["ef"] = tree_map(lambda pr: pr[1], pairs)
        new_params, new_opt, opt_metrics = opt_lib.adamw_update(
            params, grads, opt_state, tcfg.opt)
        out["params"], out["opt"] = new_params, new_opt
        m = {"loss": loss, **opt_metrics}
        for k, v in metrics.items():
            m[k] = v
        return out, m

    return train_step


def init_train_state(init_fn: Callable, tcfg: TrainConfig,
                     gen: torch.Generator, device="cuda") -> Dict:
    """Parameters from ``init_fn(gen, device=...)`` (a ``ModelAPI.init``),
    zero optimizer state and, with ``compress_grads``, a zero error-feedback
    tree, all on ``device`` (the card unless the caller asks for the CPU or
    ``meta``)."""
    if torch.device(device).type != "meta":
        device = resolve_device(device)
    params = init_fn(gen, device=device)
    state = {"params": params,
             "opt": opt_lib.init_opt_state(params, tcfg.opt)}
    if tcfg.compress_grads:
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
    return state


def train_state_shape(init_fn: Callable, tcfg: TrainConfig):
    """The train state with every tensor on the ``meta`` device: shapes and
    dtypes, nothing drawn or allocated (the reference's ``eval_shape``)."""
    return init_train_state(init_fn, tcfg, torch.Generator(), device="meta")
