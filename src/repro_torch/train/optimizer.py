"""Optimizers: AdamW and SGD with momentum, as the JAX package has them.

AdamW with decoupled weight decay, global-norm gradient clipping, cosine LR
schedule with warmup, and configurable optimizer-state dtype:
  * f32 (default)
  * bf16 (halves the optimizer's memory)
  * int8 block-quantized moments (``Packed8``: per-block absmax scaling like
    8-bit Adam)

The arithmetic is the reference's, op for op, in float32. The updates run
under ``torch.no_grad()`` and write the new values into the tensors they
were given (parameters, moments and the step of the state dict ``{"m", "v",
"step"}``), and return those same objects, where the reference returns new
arrays: a caller that keeps an old value must copy it first
(``CheckpointManager.save`` does).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.collectives import (dequantize_int8,
                                                 quantize_int8)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"          # float32 | bfloat16 | int8
    quant_block: int = 256


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor, whose device
    the result takes), in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * torch.clamp(prog, 0, 1)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# --------------------------------------------------------------------- #
# int8 block quantization for moments
# --------------------------------------------------------------------- #
class Packed8:
    """int8 block-quantized moment: ``q`` (blocks, block) int8, ``s``
    (blocks, 1) float32 and the moment's ``shape``."""

    def __init__(self, q, s, shape):
        self.q, self.s, self.shape = q, s, tuple(shape)

    def __repr__(self) -> str:
        return f"Packed8(shape={self.shape}, blocks={tuple(self.q.shape)})"


def _quant(x: torch.Tensor, block: int) -> Packed8:
    return Packed8(*quantize_int8(x, block))


def _dequant(p: Packed8) -> torch.Tensor:
    return dequantize_int8(p.q, p.s, p.shape)


def _to_state_dtype(x: torch.Tensor, cfg: OptConfig):
    if cfg.state_dtype == "float32":
        return x.to(torch.float32)
    if cfg.state_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if cfg.state_dtype == "int8":
        return _quant(x, cfg.quant_block)
    raise ValueError(cfg.state_dtype)


def _from_state_dtype(x, cfg: OptConfig) -> torch.Tensor:
    if isinstance(x, Packed8):
        return _dequant(x)
    return x.to(torch.float32)


def _store(dst, new) -> None:
    """Write a new state value into the tensors that hold the old one."""
    if isinstance(dst, Packed8):
        dst.q.copy_(new.q)
        dst.s.copy_(new.s)
    else:
        dst.copy_(new)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (a
    ``Packed8`` is a leaf), as a tree of the results."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments in the state dtype, on each parameter's device, and a
    0-d int32 step."""
    def zeros():
        return tree_map(lambda p: _to_state_dtype(
            torch.zeros_like(p, dtype=torch.float32), cfg), params)

    dev = next(tree_leaves(params)).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient element's square, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: OptConfig,
                 mask: Optional[Any] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, opt_state, metrics): the parameters and moments are
    updated in place. ``mask``: a tree of weight-decay factors like
    ``params`` (default: 1.0 for tensors of two or more dimensions, else
    0.0, the reference's heuristic that exempts norms and biases)."""
    step = opt_state["step"].add_(1)
    lr = lr_at(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v, decay):
        g = g.to(torch.float32) * scale
        m_f = cfg.b1 * _from_state_dtype(m, cfg) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _from_state_dtype(v, cfg) + (1 - cfg.b2) * \
            torch.square(g)
        u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        p_f = p.to(torch.float32)
        p_new = p_f - lr * (u + cfg.weight_decay * p_f * decay)
        p.copy_(p_new)
        _store(m, _to_state_dtype(m_f, cfg))
        _store(v, _to_state_dtype(v_f, cfg))

    if mask is None:
        mask = tree_map(lambda p: float(p.dim() >= 2), params)
    tree_map(upd, params, grads, opt_state["m"], opt_state["v"], mask)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def sgd_update(params, grads, opt_state, cfg: OptConfig):
    """Plain SGD w/ momentum in m (baseline for tests); in place."""
    lr = lr_at(cfg, opt_state["step"].add_(1))

    def upd(p, g, m):
        m_f = 0.9 * _from_state_dtype(m, cfg) + g.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * m_f)
        _store(m, _to_state_dtype(m_f, cfg))

    tree_map(upd, params, grads, opt_state["m"])
    return params, opt_state, {"lr": lr}
