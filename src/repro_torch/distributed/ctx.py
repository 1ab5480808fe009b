"""Logical-axis sharding context.

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "embed")``); a context installed by the launcher
maps logical names to physical mesh axes, and ``shard`` redistributes a
``DTensor`` to that layout (the analogue of the reference's
``with_sharding_constraint``). Outside any context, and on a plain tensor,
the calls are the identity, so the same model code runs on one device
(tests, serving) and on a mesh unchanged.

Inside a context on a ``DeviceMesh``, DTensor's implicit replication is on:
the plain tensors that model code makes for itself (positions, masks, rotary
tables) are the same on every rank, so an operation that meets one beside a
``DTensor`` treats it as replicated.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

from repro_torch.distributed.sharding import (_axis_size, mesh_axes,
                                              placements, spec_of)

_state = threading.local()

Axis = Union[None, str, Tuple[str, ...]]

# Default logical -> physical rules (physical axes: pod, data, model).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,                 # sequence sharding enabled per-config ("model")
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "fsdp": ("pod", "data"),     # parameter sharding over the data axes
}


class ShardingCtx:
    def __init__(self, mesh, rules: Optional[Dict[str, Axis]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def spec(self, *logical: Optional[str]) -> tuple:
        names = tuple(mesh_axes(self.mesh))
        axes = []
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            phys = self.rules.get(name)
            if phys is None:
                axes.append(None)
            else:
                # drop axes absent from the mesh (e.g. "pod" on single-pod)
                if isinstance(phys, tuple):
                    phys = tuple(a for a in phys if a in names)
                    phys = phys if phys else None
                elif phys not in names:
                    phys = None
                axes.append(phys)
        return spec_of(axes)


def current() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Dict[str, Axis]] = None):
    prev = current()
    _state.ctx = ShardingCtx(mesh, rules)
    try:
        if hasattr(mesh, "mesh_dim_names"):               # a DeviceMesh
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield _state.ctx
        else:
            yield _state.ctx
    finally:
        _state.ctx = prev


def shard(x, *logical: Optional[str]):
    """Constrain ``x`` to the logical spec under the active context (else
    the identity, as it is on a plain tensor): a ``DTensor`` is
    redistributed to the spec's placements.

    Axes whose size does not divide the dimension are dropped: the layout
    never asks for an uneven shard.
    """
    ctx = current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = ctx.spec(*logical)
    clean = []
    for dim, phys in zip(x.shape, tuple(spec) + (None,) * (x.ndim - len(spec))):
        n = _axis_size(ctx.mesh, phys)
        clean.append(phys if (n > 1 and dim % n == 0) or n == 1 else None)
    return x.redistribute(x.device_mesh, placements(ctx.mesh, clean))


def named_sharding(*logical: Optional[str]):
    """``(mesh, placements)`` of the logical spec under the active context,
    or None outside one."""
    ctx = current()
    if ctx is None:
        return None
    return ctx.mesh, placements(ctx.mesh, ctx.spec(*logical))
