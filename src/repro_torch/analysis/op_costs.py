"""Per-rank costs of a step, read from the operations that ran.

The counterpart of the reference's ``analysis/hlo_costs.py``. The reference
compiles the sharded step and parses the per-partition HLO, scaling each
while body by its trip count. The port runs the step: ``OpCounter`` is a
``TorchDispatchMode`` that sees every **rank-local** operation, the ones
``DTensor`` issues on its local shards and the collectives of its
redistributions, and sums

  * dot flops (products, batched products, attention) and convolution flops
    (forward and backward), by ``torch.utils.flop_counter``'s formulas,
  * collective *result* bytes by op (the reference's convention,
    ``roofline.py``): every ``_c10d_functional`` collective (DTensor's) and
    every ``c10d`` one (``torch.distributed``'s calls, the expert-parallel
    dispatch's); ``wait_tensor``, ``_wrap_tensor_autograd`` and barriers
    move nothing,
  * the peak of live local bytes: the arguments given to ``track`` plus
    every storage an operation made, until it is freed.

The port's loops (layers, microbatches, KV blocks) are Python loops, so
every trip runs and is counted: no trip counts are needed.

Two things seen under the mode are not the step's work and are left out.
``DTensor``'s sharding propagation runs an operation on fake global-shape
tensors the first time it meets a new signature (to learn the output's
shape); the counter skips any operation whose output is a ``FakeTensor``,
so a cold and a warm run count the same. On ``meta``
tensors no ``wait_tensor`` is issued; it is never counted, so ``meta`` and
real tensors count the same.

On a CPU mesh (the dry run's), DTensor turns a shard-to-shard
redistribution into ``all_gather`` + chunk instead of ``all_to_all``
(torch's gloo fallback): such bytes are an all-gather's result.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the reference's names for the collectives it parses from HLO
_COLL_NAMES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLL_NAMES.update({
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast_": "broadcast"})
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_NOT_MOVED = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
              "monitored_barrier_")
_CONV_OPS = ("convolution", "_convolution", "cudnn_convolution",
             "convolution_overrideable", "_slow_conv2d_forward",
             "convolution_backward")


@dataclass
class OpCosts:
    """Counted costs of one rank, in the shape of the reference's
    ``LoopAwareCosts``; ``coll_by_op`` is ``{op: (count, bytes)}``."""
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    collective_bytes: float = 0.0
    coll_by_op: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    peak_bytes: int = 0
    arg_bytes: int = 0
    n_ops: int = 0

    @property
    def flops(self) -> float:
        return self.dot_flops + self.conv_flops

    def to_json(self) -> dict:
        return dict(asdict(self), flops=self.flops)


def _local(t):
    """A ``DTensor``'s local shard, read without dispatching an op (which
    a counter's mode would see)."""
    return t._local_tensor if isinstance(t, DTensor) else t


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)``; then ``c.costs``. Give the
    step's arguments to ``track`` first so that the peak includes them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.costs = OpCosts()
        self._kinds = {}
        self._live = 0
        self._held = {}                # id(storage) -> weak reference

    # -------------------------------------------------------------- memory
    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = weakref.ref(st, functools.partial(self._free, key,
                                                            n))
        self._live += n
        return n

    def _free(self, key: int, n: int, _ref) -> None:
        del self._held[key]
        self._live -= n

    def track(self, *trees: Any) -> None:
        """Count the live bytes of these trees (``DTensor``s by their local
        shards) as arguments."""
        for leaf in tree_leaves(list(trees)):
            if isinstance(leaf, torch.Tensor):
                self.costs.arg_bytes += self._hold(_local(leaf))
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)

    # ---------------------------------------------------------- dispatch
    def _kind(self, func):
        """What an op is to the counter, cached per op: a collective (and
        its name), a product or a convolution (and its flop formula), a
        no-op of the collectives, or anything else; and whether its
        outputs may be new memory (not for an op that writes in place)."""
        k = self._kinds.get(func)
        if k is None:
            name = func._opname
            fresh = not func._schema.is_mutable
            if func.namespace in _COLL_NAMESPACES:
                k = ("skip", None, fresh) if name in _NOT_MOVED else \
                    ("coll", _COLL_NAMES.get(name, name), fresh)
            elif func._overloadpacket in self._flops:
                k = ("conv" if name in _CONV_OPS else "dot",
                     self._flops[func._overloadpacket], fresh)
            else:
                k = ("op", None, fresh)
            self._kinds[func] = k
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor's dispatch issues local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = (out,) if isinstance(out, torch.Tensor) else _tensors(
            out if isinstance(out, (tuple, list)) else (out,))
        for o in outs:
            if isinstance(o, FakeTensor):
                return out             # sharding propagation, not the step
        kind, what, fresh = self._kind(func)
        if kind == "skip":
            return out
        if kind == "coll":
            b = sum(o.numel() * o.element_size() for o in outs)
            c, tot = self.costs.coll_by_op.get(what, (0, 0))
            self.costs.coll_by_op[what] = (c + 1, tot + b)
            self.costs.collective_bytes += b
        elif kind == "dot":
            self.costs.dot_flops += float(what(*args, **kwargs, out_val=out))
        elif kind == "conv":
            self.costs.conv_flops += float(what(*args, **kwargs, out_val=out))
        self.costs.n_ops += 1
        if fresh:                      # a view is no new memory either
            for o in outs:
                if o._base is None:
                    self._hold(o)
            if self._live > self.costs.peak_bytes:
                self.costs.peak_bytes = self._live
        return out


def _tensors(xs):
    """The tensors among ``xs`` and in its lists and tuples, one level
    deep (an op's arguments)."""
    found = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, (list, tuple)):
            found.extend(y for y in x if isinstance(y, torch.Tensor))
    return found


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCosts)``, the arguments counted as live."""
    with OpCounter() as c:
        c.track(args, kwargs)
        out = fn(*args, **kwargs)
    return out, c.costs
