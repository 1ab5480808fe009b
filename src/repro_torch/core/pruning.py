"""One-shot magnitude pruning (§III of the paper).

Per-layer thresholds tau_w zero out weights with |w| < tau_w at compile time
(weight sparsity S_w, static); per-layer tau_a are applied at run time by the
clip units (``models.common.act_clip`` / the ``act_clip`` kernel), giving
dynamic activation sparsity S_a. No fine-tuning (one-shot, post-training),
exactly as in the paper.

Thresholds are parameterized by *target sparsity* (quantile of |w|): the TPE
search proposes sparsity levels in [0, s_max] and we derive tau from the
weight distribution — numerically better-conditioned than raw thresholds and
identical in expressive power (monotone bijection).

Every function takes tensors on any device and keeps its results there;
scalars (``sparsity``, ``n``) may be Python numbers, numpy scalars or 0-d
tensors. Scalar arithmetic is float32, as in the JAX package (x64 off), so
that thresholds and masks agree with it on the same arrays.

The thresholds and pruners also take B proposals at once, as the JAX
package's do under ``vmap``: a (B,) tensor of sparsities (or taus, or keep
counts) gives B results stacked on a new leading axis, each operation for
operation the one a single proposal gets. Nothing here reads a tensor back
to the host or copies a host value to the card, so a CUDA graph can capture
them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _scalar(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype on ``like``'s device."""
    dtype = dtype or like.dtype
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=dtype)
    return torch.full((), float(v), dtype=dtype, device=like.device)


# --------------------------------------------------------------------- #
# Weight pruning
# --------------------------------------------------------------------- #
def threshold_for_sparsity(w: torch.Tensor, sparsity) -> torch.Tensor:
    """tau such that P(|w| < tau) ~= sparsity."""
    return threshold_for_sparsity_sorted(sorted_abs(w), sparsity)


def prune_tensor(w: torch.Tensor, tau) -> torch.Tensor:
    """Zero |w| < tau. A 1-D ``tau`` of B proposals' thresholds gives the B
    pruned copies of ``w``, (B, *w.shape); any other ``tau`` broadcasts
    against ``w``."""
    if not isinstance(tau, torch.Tensor):
        tau = _scalar(tau, w)
    elif tau.dim() == 1:
        w, tau = w.unsqueeze(0), tau.reshape((-1,) + (1,) * w.dim())
    return torch.where(w.abs() >= tau, w, torch.zeros_like(w))


def sorted_abs(w: torch.Tensor) -> torch.Tensor:
    """Sorted |w| vector — the precomputable half of a quantile threshold.
    Weights are constant across a whole sparsity search, so sorting once
    and gathering per proposal replaces the O(n log n) sort inside every
    evaluation."""
    return torch.sort(w.abs().reshape(-1)).values


def sorted_quantile(asort: torch.Tensor, q) -> torch.Tensor:
    """Linear-interpolation quantile ``q`` (a scalar or a tensor of them) of
    a pre-sorted 1-D tensor.

    Follows ``jax.numpy.quantile``'s arithmetic operation for operation, in
    the array's dtype: scale ``q * (n - 1)``, floor / ceil, clamp, two
    gathers, lerp as ``low * lw + high * hw``. ``torch.quantile`` uses
    another lerp form (and caps its input at 16M elements), so it is not
    used. Parity with the JAX package is tested on the same arrays."""
    q = _scalar(q, asort)
    n = torch.full((), asort.shape[0], dtype=asort.dtype, device=asort.device)
    q = q * (n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    zero = torch.zeros((), dtype=asort.dtype, device=asort.device)
    low = torch.clamp(low, zero, n - 1)
    high = torch.clamp(high, zero, n - 1)
    low_value = torch.take(asort, low.to(torch.int64))
    high_value = torch.take(asort, high.to(torch.int64))
    return low_value * low_weight + high_value * high_weight


def threshold_for_sparsity_sorted(asort: torch.Tensor, sparsity
                                  ) -> torch.Tensor:
    """``threshold_for_sparsity`` reading a ``sorted_abs`` table instead of
    sorting — the same tau (same clip/zero-floor semantics)."""
    s = _scalar(sparsity, asort)
    q = sorted_quantile(asort, torch.clamp(s, 0.0, 1.0))
    return torch.where(s <= 0.0, torch.zeros_like(q), q)


def prune_by_sparsity(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    return prune_tensor(w, threshold_for_sparsity(w, sparsity))


def sparsity_of(w: torch.Tensor) -> float:
    return float((w == 0).to(torch.float32).mean())


def _tiles(w2: torch.Tensor, bk: int, bn: int):
    K, N = w2.shape
    pk, pn = (-K) % bk, (-N) % bn
    wp = F.pad(w2, (0, pn, 0, pk))
    Kt, Nt = (K + pk) // bk, (N + pn) // bn
    return wp.reshape(Kt, bk, Nt, bn), pk, pn


def tile_sparsity(w: torch.Tensor, bk: int = 128, bn: int = 128) -> float:
    """Fraction of (bk, bn) weight tiles that are entirely zero — the compute
    a tile-skipping backend can actually skip (static tile schedule)."""
    if w.dim() != 2:
        w = w.reshape(-1, w.shape[-1])
    t, _, _ = _tiles(w, bk, bn)
    nonzero = (t != 0).any(dim=3).any(dim=1)
    return float(1.0 - nonzero.to(torch.float32).mean())


def tile_prune(w: torch.Tensor, sparsity, bk: int = 128, bn: int = 128):
    """Tile-structured one-shot pruning: zero out whole 128-aligned
    (bk, bn) tiles, lowest mean-|w| first, targeting a ``sparsity``
    fraction of all-zero tiles — the only sparsity pattern a tile-skipping
    backend can actually skip (``LayerCost.s_w_tile``).

    Non-2D weights flatten leading dims (a conv's (k, k, cin, cout) prunes
    as the (k*k*cin, cout) matmul the lowering runs); ragged edges are
    zero-padded for tile scoring, so boundary tiles rank slightly lower.
    Returns ``(pruned w, realized fraction of all-zero tiles)`` — realized
    is *measured* on the pruned tensor (quantile ties can under-shoot the
    target; pre-existing zero tiles count), a 0-d float32 tensor. A (B,)
    ``sparsity`` gives ((B, *w.shape), (B,)): the tile scores are ``w``'s,
    computed once."""
    orig_shape = w.shape
    w2 = w if w.dim() == 2 else w.reshape(-1, w.shape[-1])
    K, N = w2.shape
    tiles, pk, pn = _tiles(w2, bk, bn)
    norms = tiles.abs().mean(dim=(1, 3))
    s = _scalar(sparsity, norms)
    lead = s.shape                                  # () or (B,)
    tau = sorted_quantile(torch.sort(norms.reshape(-1)).values,
                          torch.clamp(s, 0.0, 1.0))
    keep = norms >= tau[..., None, None]
    keep = torch.where(s[..., None, None] <= 0.0, torch.ones_like(keep), keep)
    pruned_tiles = tiles * keep[..., :, None, :, None].to(tiles.dtype)
    nonzero = (pruned_tiles != 0).any(dim=-1).any(dim=-2)
    zero_frac = 1.0 - nonzero.to(torch.float32).mean(dim=(-2, -1))
    out = pruned_tiles.reshape(lead + (K + pk, N + pn))[..., :K, :N]
    return out.reshape(lead + tuple(orig_shape)), zero_frac


# --------------------------------------------------------------------- #
# Sparsity patterns: the pattern axis the search picks per matrix kind.
# "unstructured" is the paper's element/tile pruner; "nm" keeps N of every M
# consecutive weights along the reduction dim; "hierarchical" composes
# tile-level pruning with intra-tile N:M (HighLight-style); "activation"
# realizes the budget as runtime activation clipping instead of weight zeros
# (SparseNN-style).
# --------------------------------------------------------------------- #
PATTERNS = ("unstructured", "nm", "hierarchical", "activation")

#: group size M of the N:M patterns — 8 matches the sublane granularity a
#: structured decoder indexes (achievable sparsity grid is k/8, k=0..7)
NM_M = 8


def nm_keep_for_sparsity(s, m: int = NM_M):
    """Keep-count n of the largest achievable N:M grid point 1 - n/m <= s
    (float32 arithmetic); never returns < 1 (a group always keeps at least
    one weight, so the grid tops out at 1 - 1/m). A 0-d tensor for a tensor
    ``s``, else a numpy float32."""
    if isinstance(s, torch.Tensor):
        z = torch.floor(torch.clamp(s.to(torch.float32), 0.0, 1.0) * m)
        return torch.clamp(m - z, 1, m)
    z = np.floor(np.clip(np.float32(s), np.float32(0.0), np.float32(1.0))
                 * np.float32(m))
    return np.clip(np.float32(m) - z, np.float32(1), np.float32(m))


def nm_sparsity_grid(s, m: int = NM_M):
    """Realized sparsity 1 - n/m of ``nm_keep_for_sparsity`` — numpy (the
    analytic LM evaluator snaps targets with this)."""
    s = np.clip(np.asarray(s, dtype=np.float64), 0.0, 1.0)
    n = np.clip(m - np.floor(s * m), 1, m)
    return 1.0 - n / m


def nm_prune(w: torch.Tensor, n, m: int = NM_M) -> torch.Tensor:
    """N:M structured pruning: within every group of ``m`` consecutive
    weights along the reduction dim (rows of the (m_dot, cout) matmul view;
    non-2D weights flatten leading dims like ``tile_prune``), keep the ``n``
    largest-|w| and zero the rest. Exactly ``n`` survivors per group —
    ties break to the lower row index (stable descending argsort), so
    ``sparsity_of`` on a dense input is exactly ``1 - n/m`` when the
    reduction dim divides ``m``. A (B,) ``n`` gives the B pruned copies,
    (B, *w.shape)."""
    return _nm_prune(w, n, m, batched=False)


def _nm_prune(w: torch.Tensor, n, m: int, batched: bool) -> torch.Tensor:
    """``nm_prune`` of ``w``, or with ``batched`` of each of the B weights
    stacked on ``w``'s leading axis, its own ``n[b]`` each."""
    lead = tuple(w.shape[:1]) if batched else ()
    shape = w.shape[len(lead):]
    w2 = w.reshape(lead + (-1, shape[-1]))
    K, N = w2.shape[-2:]
    pad = (-K) % m
    wp = F.pad(w2, (0, 0, 0, pad))
    g = wp.reshape(lead + (-1, m, N))               # (..., groups, m, N)
    order = torch.argsort(g.abs(), dim=-2, descending=True, stable=True)
    ranks = torch.argsort(order, dim=-2)            # rank of each element
    nn = _scalar(n, g, torch.float32)
    keep = ranks < nn.reshape(nn.shape + (1, 1, 1))
    out = (g * keep.to(g.dtype)).reshape(keep.shape[:-3] + (K + pad, N))
    return out[..., :K, :].reshape(keep.shape[:-3] + tuple(shape))


def hierarchical_prune(w: torch.Tensor, tile_frac, n, m: int = NM_M,
                       bk: int = 128, bn: int = 128):
    """Hierarchical structured pruning (HighLight): tile-level pruning then
    intra-tile N:M — literally the composition
    ``nm_prune(tile_prune(w, tile_frac)[0], n, m)``. Zeroed tiles keep
    all-zero groups under N:M (zeros rank last), so both levels survive in
    the output. Returns ``(pruned w, realized all-zero-tile fraction)`` like
    ``tile_prune``. (B,) ``tile_frac`` and ``n`` give B pruned copies, each
    tile-pruned and then N:M-pruned with its own values."""
    wt, ztile = tile_prune(w, tile_frac, bk=bk, bn=bn)
    return _nm_prune(wt, n, m, batched=wt.dim() > w.dim()), ztile


def act_realize_pattern(s_w, s_a):
    """Activation-pattern realization hook: the searched weight-axis budget
    is spent as EXTRA runtime activation clipping (the weights stay dense).
    Independent clip events compose like pair sparsity: the combined
    activation target is 1 - (1-s_a)(1-s_w). numpy/torch generic."""
    return 1.0 - (1.0 - s_a) * (1.0 - s_w)


def prune_params(params: Dict[str, Any],
                 sparsities: Dict[str, float],
                 match: Optional[Callable[[str], bool]] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """One-shot prune a params tree (nested dicts of tensors).

    sparsities: maps flat path ("blocks/attn/wq") to target sparsity. For
    stacked-layer params a 1-leaf path prunes each layer slice with its own
    quantile threshold when the value is a (L,)-vector, or uniformly when
    scalar. Returns (pruned_params, achieved element sparsity per path).
    """
    flat = _flatten(params)
    achieved: Dict[str, float] = {}
    new_flat = {}
    for path, w in flat.items():
        s = sparsities.get(path)
        if s is None or (match and not match(path)):
            new_flat[path] = w
            continue
        if np.ndim(s) == 1 and w.dim() >= 2 and w.shape[0] == len(s):
            taus = torch.stack([
                threshold_for_sparsity(w[i], np.float32(s[i]))
                for i in range(w.shape[0])])
            w2 = prune_tensor(w, taus.reshape((-1,) + (1,) * (w.dim() - 1)))
        else:
            w2 = prune_by_sparsity(w, float(np.mean(s)))
        new_flat[path] = w2
        achieved[path] = sparsity_of(w2)
    return _unflatten(new_flat), achieved


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


PRUNABLE_TOKENS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "wq_a", "wq_b", "wkv_a", "wkv_b", "router", "shared_w",
                   "cm_w", "wr", "wg", "in_proj", "out_proj", "lm_head", "w")


def default_prunable(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return any(leaf == t or leaf.startswith(t) for t in PRUNABLE_TOKENS) and \
        "norm" not in path and "ln" not in leaf and "embed" not in path


# --------------------------------------------------------------------- #
# Activation sparsity (dynamic): calibration + analytic model
# --------------------------------------------------------------------- #
def act_sparsity_gaussian(tau: float, sigma: float = 1.0) -> float:
    """P(|x| < tau) for x ~ N(0, sigma^2) — the analytic estimate used to
    extrapolate calibration results to full-size LMs (pre-matmul activations
    sit behind RMSNorm, so sigma ~= 1)."""
    return math.erf(tau / (sigma * math.sqrt(2.0)))


def tau_for_act_sparsity(s: float, sigma: float = 1.0) -> float:
    """Inverse of ``act_sparsity_gaussian`` via bisection."""
    if s <= 0:
        return 0.0
    lo, hi = 0.0, 8.0 * sigma
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if act_sparsity_gaussian(mid, sigma) < s:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def calibrate_activation_sparsity(forward_stats: Callable[[], Dict[str, Any]]
                                  ) -> Dict[str, float]:
    """Run a stats-collecting forward (e.g. cnn.forward(collect_stats=True))
    and return measured per-layer input zero fractions."""
    stats = forward_stats()
    return {k: float(v) for k, v in stats.items()}
