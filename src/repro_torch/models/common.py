"""Shared model building blocks (plain functions on tensors)."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed import ctx as shard_ctx
from repro_torch.distributed.ctx import reduce_partial


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, in_axis=-2, scale=1.0,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """LeCun-normal over the contracted axis; stored in float32, cast at use.

    Drawn from ``gen`` on the generator's device and then moved to ``device``
    (the card, unless the caller asks for ``"cpu"``), so one seed gives one
    set of weights wherever they end up. On the ``meta`` device nothing is
    drawn or allocated: the tensor has the shape and dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[in_axis]
    std = scale / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) * std
    return w.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


# --------------------------------------------------------------------- #
# Normalization / activations
# --------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps=1e-5) -> torch.Tensor:
    """Normalised in float32 and cast back to the input's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _relu2(x):                                # rwkv channel-mix
    return torch.relu(x).square()


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


# --------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (..., S, 1, D/2) float32, for positions broadcastable
    to (..., S): computed once and shared by every head, layer and tensor
    rotated at those positions."""
    freqs = rope_freqs(d, theta, device=positions.device)      # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: (..., S, H, D). The split-half layout (first half of D paired with
    the second), computed in float32 and cast back."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    return rotate(x, *rope_table(positions, x.shape[-1], theta))


# --------------------------------------------------------------------- #
# Activation clipping — the paper's SPE "clip" unit (§IV).
# Values with |x| < tau are zeroed at run time (dynamic activation sparsity).
# --------------------------------------------------------------------- #
def act_clip(x: torch.Tensor, tau) -> torch.Tensor:
    """tau: scalar or per-layer scalar. ``None`` disables (identity)."""
    if tau is None:
        return x
    if not isinstance(tau, torch.Tensor):
        tau = torch.tensor(float(tau), dtype=x.dtype, device=x.device)
    return torch.where(x.abs() >= tau, x, torch.zeros_like(x))


def take_layer(stacked, i: int):
    """Slice layer i out of a stacked-parameter tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: take_layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def unstack_layers(stacked) -> list:
    """Every layer's tree of a stacked-parameter tree, as ``take_layer``
    gives them (views, no copies), made by one ``unbind`` per leaf: its
    backward is one stack of the layers' gradients, where L separate slices
    would each scatter into a zero tensor of the full stacked size."""
    if isinstance(stacked, dict):
        per_key = {k: unstack_layers(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(stacked.unbind(0))


# --------------------------------------------------------------------- #
# Rematerialisation (the JAX package's jax.checkpoint on a block)
# --------------------------------------------------------------------- #
# the plain products: ``jax.checkpoint_policies.dots_with_no_batch_dims_
# saveable`` saves dot_generals without batch dimensions; a product with one
# (``aten.bmm``: the attention's einsums, the MoE experts) is recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_fn(fn, remat):
    """``fn`` as the backward pass sees it under ``remat``: ``None`` keeps
    every activation it saves; ``"full"`` saves only its inputs and runs it
    again in the backward pass; ``"dots"`` saves the outputs of its plain
    products and recomputes the rest. The forward value is the same in all
    three."""
    if not remat:
        return fn
    if remat == "full":
        kw = {}
    elif remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(f"remat must be None, 'full' or 'dots': {remat!r}")

    def run(*args, **kwargs):
        # the recomputation may run on another thread (autograd's device
        # thread on the card): it sees the sharding context this call saw
        saw = shard_ctx.current()

        def again(*a, **k):
            with shard_ctx.installed(saw):
                return fn(*a, **k)
        return checkpoint(again, *args, use_reentrant=False, **kw, **kwargs)
    return run


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable CE in f32; logits (…, V), labels (…,) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    # a gather over a vocabulary sharded as a DTensor is a pending sum
    gold = reduce_partial(torch.gather(logits, -1,
                                       labels.to(torch.int64)[..., None]))
    return lse - gold[..., 0]
