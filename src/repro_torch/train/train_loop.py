"""Train-step factory: gradient accumulation, remat, mixed precision.

``make_train_step`` builds the ``(state, batch) -> (state, metrics)`` step of
the JAX package's ``train_loop.py``: gradients of the model's loss with
respect to the float32 master parameters (``torch.autograd.grad``),
accumulated over ``accum`` microbatches in a Python loop (the reference's
``lax.scan``), optionally int8-compressed with error feedback, then one
AdamW update. The update writes into the state's tensors (see
``optimizer``); the state returned holds the same parameter tensors.

``TrainProgram`` is the step as the reference jits it: one static-buffer
program per shape key, captured once as a CUDA graph on the card and
replayed per step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import ef_quantize
from repro_torch.models.common import dtype_of
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptConfig, Packed8, tree_map


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


# --------------------------------------------------------------------- #
# the step as one program per shape
# --------------------------------------------------------------------- #
def flat_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """path -> tensor over nested dicts, a ``Packed8`` as ``path/q`` and
    ``path/s``."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, Packed8):
        return {f"{prefix}q": tree.q, f"{prefix}s": tree.s}
    return {prefix[:-1]: tree}


def step_key(state, batch) -> Tuple:
    """A train program's shape: every state leaf's and every batch leaf's
    path, shape and dtype (what ``jax.jit`` recompiles the step for; the
    ``TrainConfig`` the step closed over fixes the rest)."""
    def shapes(tree):
        return tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(flat_leaves(tree).items()))
    return shapes(state), shapes(batch)


class StepSet:
    """One static buffer set of a shape key: the state it adopted (the
    first caller's own tensors, which the step updates in place), a copy of
    the batch, and the step over them. On the card its first call runs
    eagerly on a side stream and captures the step into a CUDA graph (in
    the program's memory pool); every later call replays it. On the CPU
    every call runs ``run`` eagerly."""

    def __init__(self, step_fn: Callable, state, batch):
        self.step_fn = step_fn
        self.state = state
        self.batch = tree_map(lambda t: t.clone(), batch)
        self._state_leaves = flat_leaves(state)
        self._batch_leaves = flat_leaves(self.batch)
        self.graph = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None

    def load(self, state, batch) -> None:
        """Copy ``batch``, and each leaf of ``state`` that is not already
        this set's own tensor, into the set."""
        for k, v in flat_leaves(state).items():
            if v is not self._state_leaves[k]:
                self._state_leaves[k].copy_(v)
        for k, v in flat_leaves(batch).items():
            self._batch_leaves[k].copy_(v)

    def run(self) -> Dict[str, torch.Tensor]:
        """The static step: ``step_fn`` on the set's state and batch, each
        state leaf it returns as a new tensor (the error feedback of
        ``compress_grads``) copied back into the set's own. Returns the
        metrics."""
        new, metrics = self.step_fn(self.state, self.batch)
        for k, v in flat_leaves(new).items():
            if v is not self._state_leaves[k]:
                self._state_leaves[k].copy_(v)
        return metrics


def _dtensor_leaves(tree):
    from torch.distributed.tensor import DTensor
    return [k for k, v in flat_leaves(tree).items()
            if isinstance(v, DTensor)]


class TrainProgram:
    """``step_fn`` (a ``make_train_step``) as the reference's
    ``jax.jit(make_train_step(...))``: ``(state, batch) -> (state,
    metrics)``, one ``StepSet`` per ``step_key``.

    A call copies the batch into its set's static buffers. The state
    returned is the set's state: the state of the call that built the set,
    updated in place; a later call with a state of other tensors (one
    ``run_resilient`` restored, or a caller's copy) has each leaf copied
    into it first. The metrics are the set's static tensors, rewritten by
    the next step. On the card the set's first call is its eager run on a
    side stream, then the step is captured (``kernels.graph``) and every
    later call replays it; a failed capture raises. On the CPU every call
    runs the set's step eagerly: the caller asked for it. A state of
    ``DTensor``s raises ``ValueError``: the sharded step runs eagerly, as
    ``step_fn``. ``graphs_captured``, ``capture_s`` and
    ``graph_pool_bytes`` say what the captures cost (one pool per
    program)."""

    def __init__(self, step_fn: Callable, device="cuda"):
        self.step_fn = step_fn
        self.device = resolve_device(device)
        self._sets: Dict[Tuple, StepSet] = {}
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.graphs_captured: int = 0
        self.capture_s: float = 0.0
        #: device memory the graphs' pool holds (``warm_and_capture``)
        self.graph_pool_bytes: int = 0

    @property
    def buffer_sets(self) -> Dict[Tuple, int]:
        """Buffer sets built so far, per shape key."""
        return {k: 1 for k in self._sets}

    def __call__(self, state, batch):
        sharded = _dtensor_leaves(state) + _dtensor_leaves(batch)
        if sharded:
            raise ValueError(
                "a train state of DTensors runs the step eagerly, not as a "
                f"TrainProgram (sharded leaves: {sharded[:3]})")
        devs = {v.device.type for v in flat_leaves(state).values()}
        if devs != {self.device.type}:
            raise ValueError(f"the state lies on {sorted(devs)}, the "
                             f"program on {self.device}")
        key = step_key(state, batch)
        ss = self._sets.get(key)
        if ss is None:
            ss = self._sets[key] = StepSet(self.step_fn, state, batch)
        else:
            ss.load(state, batch)
        if ss.graph is not None:
            ss.graph.replay()
            return ss.state, ss.metrics
        if self.device.type != "cuda":
            return ss.state, ss.run()
        return ss.state, self._capture(ss)

    def _capture(self, ss: StepSet) -> Dict[str, torch.Tensor]:
        """A set's first call on the card: run eagerly on a side stream (its
        metrics are this step's), then captured into the set's graph."""
        from repro_torch.kernels.graph import warm_and_capture
        t0 = time.perf_counter()
        graph, metrics, static, grew = warm_and_capture(ss.run, self._pool,
                                                        self.device)
        bad = [k for k, v in static.items()
               if not (isinstance(v, torch.Tensor)
                       and v.device.type == "cuda")]
        if bad:
            raise RuntimeError(f"metrics {bad} of the captured step are not "
                               "tensors on the card: a replay cannot "
                               "rewrite them")
        ss.graph, ss.metrics = graph, static
        self.graph_pool_bytes += grew
        self.graphs_captured += 1
        self.capture_s += time.perf_counter() - t0
        return metrics
