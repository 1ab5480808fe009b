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

Where DTensor cannot take a layout that GSPMD takes silently, model code
calls one of the helpers below, each the plain operation on a plain tensor:
``shard`` also constrains the gradient (as ``with_sharding_constraint``
constrains the cotangent), ``reshape`` redistributes what a reshape cannot
carry (forward and backward), ``per_rank`` runs a function on each rank's
local shards (attention, recurrences over time), ``whole`` and
``reduce_partial`` unsplit a dimension or carry out a pending sum.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch

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
def installed(ctx: Optional[ShardingCtx]):
    """``ctx`` as this thread's context for the block (None: none). The
    context is per thread; code that runs model code on another thread
    (the recomputation of a checkpointed block, which runs on autograd's
    device thread on the card) installs the context its caller saw."""
    prev = current()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Dict[str, Axis]] = None):
    """A context on ``mesh`` for this thread (other threads, a prefetch
    worker or a checkpoint writer, do not see it)."""
    with installed(ShardingCtx(mesh, rules)) as ctx:
        if hasattr(mesh, "mesh_dim_names"):               # a DeviceMesh
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield ctx
        else:
            yield ctx


def shard(x, *logical: Optional[str]):
    """Constrain ``x`` to the logical spec under the active context (else
    the identity, as it is on a plain tensor): a ``DTensor`` is
    redistributed to the spec's placements.

    Axes whose size does not divide the dimension are dropped: the layout
    never asks for an uneven shard.
    """
    ctx = current()
    if ctx is None or not is_sharded(x):
        return x
    spec = ctx.spec(*logical)
    clean = []
    for dim, phys in zip(x.shape, tuple(spec) + (None,) * (x.ndim - len(spec))):
        n = _axis_size(ctx.mesh, phys)
        clean.append(phys if (n > 1 and dim % n == 0) or n == 1 else None)
    place = placements(ctx.mesh, clean)
    if tuple(x.placements) == tuple(place):
        return x
    return _Constrain.apply(x, place)


class _Constrain(torch.autograd.Function):
    """A ``DTensor`` redistributed to ``place``, and its gradient too: the
    reference's ``with_sharding_constraint`` constrains the cotangent as
    well, where ``redistribute``'s backward would return the gradient in
    the input's layout (whatever DTensor had chosen there, a sequence
    sharding that later reshapes cannot carry, or a masked pending sum,
    which DTensor cannot make from a pending sum)."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return _dense(x.redistribute(x.device_mesh, place))

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == tuple(ctx.place):
            return g, None
        return _dense(g.redistribute(g.device_mesh, ctx.place)), None


def _dense(x):
    """A ``DTensor`` whose local shard is contiguous. A shard moved to
    another dimension (on a CPU mesh, an all-gather and a chunk) can come
    back as a strided slice, which the local ``view`` of a later reshape
    refuses."""
    if x.to_local().is_contiguous():
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def per_rank(fn, args, specs, like, host: bool = False):
    """``fn(*args)`` on each rank's local shards, for a loop whose every step
    is elementwise over the sharded dimensions (a recurrence over time):
    GSPMD partitions the reference's scan so, and DTensor would otherwise
    dispatch each step as a global operation. Each argument is laid out by
    its logical spec as ``shard`` lays it out (a plain tensor is taken as
    replicated and cut locally); output i takes the layout of argument
    ``like[i]``. Without a ``DTensor`` argument this is ``fn(*args)``;
    with one it needs a context.

    ``host``: on ``meta`` shards (a dry run), run ``fn`` on zeros of the
    shards' shapes on the host instead, for a loop of many small steps
    (a recurrence over time), whose meta kernels, Python each, would cost
    several times more than the host's."""
    if not any(is_sharded(a) for a in args):
        return fn(*args)
    ctx = current()
    if ctx is None:
        raise ValueError("a call on DTensors needs a sharding context "
                         "(use_sharding) to lay its shards out")
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ctx.mesh
    laid = []
    for a, spec in zip(args, specs):
        if not is_sharded(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        laid.append(shard(a, *spec))
    local = [a.to_local() for a in laid]
    if host and local[0].device.type == "meta":
        outs = [_Zeros.apply(o, "meta")
                for o in fn(*(_Zeros.apply(t, "cpu") for t in local))]
    else:
        outs = fn(*local)
    return tuple(
        DTensor.from_local(o, mesh, laid[i].placements, run_check=False)
        for o, i in zip(outs, like))


class _Zeros(torch.autograd.Function):
    """Zeros of ``x``'s shape and dtype on ``device``; the gradient goes
    back as zeros on ``x``'s device (values do not matter where this is
    used: a dry run on ``meta`` tensors)."""

    @staticmethod
    def forward(ctx, x, device):
        ctx.device = x.device
        return torch.zeros(x.shape, dtype=x.dtype, device=device)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros(g.shape, dtype=g.dtype, device=ctx.device), None


def divides(logical: str, size: int) -> bool:
    """Whether a dimension of ``size`` can be sharded over the mesh axes
    that ``logical`` maps to under the active context (``shard``'s rule)."""
    ctx = current()
    if ctx is None:
        return True
    n = _axis_size(ctx.mesh, ctx.spec(logical)[0])
    return n == 1 or size % n == 0


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _view_groups(src: Tuple[int, ...], dst: Tuple[int, ...]):
    """Pairs (source dims, destination dims) of a reshape, each pair the
    smallest run of dimensions whose sizes multiply to the same number."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= src[i]
                i += 1
            else:
                outs.append(j)
                b *= dst[j]
                j += 1
        groups.append((ins, outs))
    return groups


def _fit(x, shape):
    """``x`` redistributed so that DTensor can view it as ``shape``: a
    dimension split into pieces keeps its outermost shards that divide the
    first piece; one merged in front of others keeps those that divide it
    evenly; one merged behind another dimension, or regrouped, is
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for ins, outs in _view_groups(tuple(x.shape), tuple(shape)):
        for d in ins:
            where[d] = (ins, outs)
    place = list(x.placements)
    by_dim: Dict[int, list] = {}
    for m, p in enumerate(place):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(m)
    drop = []
    for d, ms in by_dim.items():
        ins, outs = where[d]
        if d != ins[0] or len(ins) > 1 and len(outs) > 1:
            drop += ms
            continue
        n = 1
        for k, m in enumerate(ms):
            n *= x.device_mesh.size(m)
            if shape[outs[0]] % n or len(ins) > 1 and x.shape[d] % n:
                drop += ms[k:]
                break
    if not drop:
        return x
    return _dense(x.redistribute(x.device_mesh, [
        Replicate() if m in drop else p for m, p in enumerate(place)]))


def _view_shape(x, shape):
    shape = list(shape)
    if -1 in shape:
        k = shape.index(-1)
        rest = math.prod(s for s in shape if s != -1)
        shape[k] = x.numel() // rest if rest else 0
    return tuple(shape)


class _Reshape(torch.autograd.Function):
    """A ``DTensor`` reshape whose backward reshapes the gradient the same
    careful way (the gradient may come back sharded otherwise)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _view(g, ctx.src), None


def _view(x, shape):
    x = _fit(x, shape)
    if any(p.is_shard() for p in x.placements):
        # a local shard that one of DTensor's own moves left strided would
        # be refused by the local view; a mesh where nothing is split (one
        # rank) keeps the layout a plain reshape would give
        x = _dense(x)
    return x.reshape(shape)


def reshape(x, *shape: int):
    """``x.reshape(shape)``. A ``DTensor`` whose sharding the new shape
    cannot carry is first redistributed, in the forward pass and the
    backward one: a sharded dimension split so that its first piece does
    not divide by the shards (8 KV heads over a 16-way model axis, 8
    microbatches over 16 data ranks) keeps only the outer shards that
    divide it; one merged behind another dimension is replicated. That is
    the all-gather GSPMD puts around such a reshape. A plain tensor is
    reshaped as it is."""
    if not is_sharded(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, _view_shape(x, shape))


def whole(x, dim: int):
    """A ``DTensor`` with dimension ``dim`` no longer sharded (the mesh
    dimensions that shard it replicate it; its other shards kept); a plain
    tensor as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate
    place = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def reduce_partial(x):
    """A ``DTensor`` with its pending sums (``Partial`` placements) carried
    out and its shards kept, for an op that DTensor cannot apply to a
    pending sum; a plain tensor as it is."""
    if not is_sharded(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return _Constrain.apply(x, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def named_sharding(*logical: Optional[str]):
    """``(mesh, placements)`` of the logical spec under the active context,
    or None outside one."""
    ctx = current()
    if ctx is None:
        return None
    return ctx.mesh, placements(ctx.mesh, ctx.spec(*logical))
