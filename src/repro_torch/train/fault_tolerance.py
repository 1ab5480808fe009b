"""Fault tolerance: the resilient run loop and the straggler watchdog.

The failure model is the JAX package's: a device or host dies, hangs
(straggler), or the job restarts. The strategy:

  * step-atomic checkpoints (train/checkpoint.py) + deterministic data
    cursor (data/synthetic.py) => restart is exact,
  * ``run_resilient`` retries the step loop through injected/real failures,
    restoring from the newest checkpoint,
  * ``StepWatchdog`` flags stragglers: steps slower than k x the trailing
    median trigger a (configurable) callback instead of stalling the job,
  * ``elastic_remesh`` lays a restored state out on the mesh of the ranks
    that survive.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import tree_leaves

log = logging.getLogger("repro_torch.ft")


class StepWatchdog:
    """Trailing-median step timer; flags stragglers at ratio x median."""

    def __init__(self, ratio: float = 3.0, window: int = 20,
                 grace_steps: int = 3):
        self.ratio, self.window, self.grace = ratio, window, grace_steps
        self.times: List[float] = []

    def observe(self, dt: float) -> bool:
        """Returns True when dt flags a straggler."""
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) <= self.grace:
            return False
        med = float(np.median(self.times[:-1]))
        return dt > self.ratio * max(med, 1e-9)


@dataclass
class ResilienceReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: int = 0
    final_loss: float = float("nan")
    history: List[float] = field(default_factory=list)


def run_resilient(train_step: Callable, state: Any, next_batch: Callable,
                  *, steps: int, ckpt: CheckpointManager,
                  ckpt_every: int = 10,
                  fail_at: Optional[Dict[int, Exception]] = None,
                  max_restarts: int = 10,
                  watchdog: Optional[StepWatchdog] = None,
                  on_straggler: Optional[Callable] = None,
                  state_restore: Optional[Callable] = None
                  ) -> ResilienceReport:
    """Run ``steps`` train steps surviving failures.

    fail_at: {step: exception} — fault injection for tests (the exception is
    raised after the step's compute, as a crash would land). state_restore:
    maps the restored tree (tensors on the CPU) back into a train state;
    without it the tree is restored onto the device of ``state``'s
    parameters.
    """
    report = ResilienceReport()
    fail_at = dict(fail_at or {})
    step = int(state["opt"]["step"])
    device = next(tree_leaves(state["params"])).device
    restarts = 0
    while step < steps:
        try:
            while step < steps:
                t0 = time.perf_counter()
                batch = next_batch(step)
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])
                report.history.append(loss)
                step += 1
                report.steps_run += 1
                if step in fail_at:
                    raise fail_at.pop(step)
                if watchdog is not None:
                    if watchdog.observe(time.perf_counter() - t0):
                        report.straggler_events += 1
                        if on_straggler is not None:
                            state = on_straggler(state)
                if step % ckpt_every == 0 or step == steps:
                    ckpt.save(step, state, meta={"step": step})
            break
        except Exception as e:                        # noqa: BLE001
            restarts += 1
            report.restarts = restarts
            if restarts > max_restarts:
                raise
            log.warning("step %d failed (%s); restoring", step, e)
            restored = ckpt.restore_or_none(
                device="cpu" if state_restore else device)
            if restored is None:
                raise
            tree, ck_step, _ = restored
            state = state_restore(tree) if state_restore else tree
            step = ck_step
    ckpt.wait()
    report.final_loss = report.history[-1] if report.history else float("nan")
    return report


def elastic_remesh(state: Any, new_mesh, state_shape: Any) -> Any:
    """Re-shard a host state tree (numpy arrays or CPU tensors, as
    ``restore_checkpoint`` gives them, the same on every rank) onto a new
    ``DeviceMesh`` by the same rank-polymorphic rules — the 'drop a pod and
    keep training' path. Every leaf becomes a ``DTensor`` with the
    placements of ``param_specs(new_mesh, state_shape)`` (a ``Packed8``'s
    ``q`` and ``s`` alike), each rank keeping its own shard of its own copy:
    no collective runs."""
    import torch
    from repro_torch.distributed.sharding import distribute, param_specs
    from repro_torch.train.optimizer import Packed8, tree_map

    def to_mesh(x):
        if isinstance(x, Packed8):
            return Packed8(to_mesh(x.q), to_mesh(x.s), x.shape)
        return torch.as_tensor(x).to(new_mesh.device_type)

    return distribute(tree_map(to_mesh, state), new_mesh,
                      param_specs(new_mesh, state_shape))
