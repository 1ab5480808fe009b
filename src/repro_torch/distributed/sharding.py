"""Parameter / state / batch sharding rules, rank-polymorphic in axis names.

The JAX package's rules, kept as they are, for ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.

Strategy (2D "hybrid FSDP x TP", extended by a pure-DP 'pod' axis):
  * TP ('model'): attention heads, FFN hidden, vocab, experts.
  * FSDP ('pod','data'): the non-TP matrix dimension of every large weight,
    plus optimizer moments (ZeRO-3 style).
  * Activations: batch over ('pod','data'); heads/ff/vocab over 'model'.

Rules are *patterns over flattened param paths*, so one table covers every
architecture in the pool. Dims that do not divide the axis size fall back to
replication for that dim (DTensor would accept an uneven shard; the rules
prefer predictable layouts).

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names (one dimension sharded
over several mesh axes, major first), the entries of the reference's
``PartitionSpec`` (which, like it, writes a tuple of one name as the name).
``placements`` turns one into DTensor placements.

Every function reads only the mesh's axis names and sizes: a ``DeviceMesh``
(``mesh_dim_names``, ``shape``) or anything with ``axis_names`` and
``devices.shape``, as a JAX mesh has them.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

Spec = Tuple[Any, ...]

# (regex over path, spec template) — template entries name *logical* axes:
#   "tp" -> 'model';  "fsdp" -> ('pod','data');  None -> replicated
# Templates are right-aligned to the array rank (leading dims replicated), so
# stacked-layer arrays (leading L) need no special casing.
RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads
    (r"embed$", ("tp", "fsdp")),
    (r"(lm_head|unembed)$", ("fsdp", "tp")),
    (r"(enc_pos|dec_pos)$", (None, None)),
    # attention (GQA + cross): column-parallel in, row-parallel out
    (r"attn/w[qkv]$|cross/w[qkv]$", ("fsdp", "tp")),
    (r"attn/wo$|cross/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    # MLA
    (r"wq_a$|wkv_a$", ("fsdp", None)),
    (r"wq_b$|wkv_b$", (None, "tp")),
    # dense FFN
    (r"ffn/w_gate$|ffn/w_up$|shared_w_gate$|shared_w_up$", ("fsdp", "tp")),
    (r"ffn/w_down$|shared_w_down$", ("tp", "fsdp")),
    # MoE experts: shard experts when divisible (checked at apply time),
    # otherwise shard the hidden dim
    (r"ffn/(w_gate|w_up)$", ("experts", "fsdp", "tp")),      # 4D case (L,E,d,f)
    (r"ffn/w_down$", ("experts", "tp", "fsdp")),             # 4D case (L,E,f,d)
    (r"router$", ("fsdp", None)),
    # rwkv
    (r"blocks/(wr|wk|wv|wg)$", ("fsdp", "tp")),
    (r"blocks/wo$", ("tp", "fsdp")),
    (r"cm_wk$", ("fsdp", "tp")),
    (r"cm_wv$", ("tp", "fsdp")),
    (r"cm_wr$", ("fsdp", "tp")),
    (r"mix_w1$", ("fsdp", None)),
    (r"mix_w2$", (None, None, "fsdp")),
    (r"decay_a$", ("fsdp", None)),
    (r"decay_b$", (None, "fsdp")),
    # mamba
    (r"in_proj$", ("fsdp", "tp")),
    (r"out_proj$", ("tp", "fsdp")),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"(A_log|D|dt_bias)$", ("tp",)),
    (r"out_norm$", ("tp",)),
    # zamba shared block extras
    (r"shared_proj$", ("fsdp", "tp")),
    # mtp
    (r"mtp/proj$", ("fsdp", "tp")),
    # cnn
    (r"/w$", (None, None, None, "tp")),
    (r"/w1$", (None, "tp")),
    (r"/w2$", ("tp", None)),
)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):                    # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(np.prod([_axis_size(mesh, a) for a in name]))
    return mesh_axes(mesh).get(name, 1)


def _resolve(mesh, logical: Optional[str], no_fsdp: bool = False):
    names = tuple(mesh_axes(mesh))
    if logical is None:
        return None
    if logical in ("tp", "experts"):
        return "model" if "model" in names else None
    if logical == "fsdp":
        if no_fsdp:
            return None
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    return logical if logical in names else None


def _flat_axes(s) -> Tuple[str, ...]:
    return s if isinstance(s, tuple) else (s,) if s else ()


def spec_of(entries) -> Spec:
    """A spec of these entries, a tuple of one name written as the name
    (``PartitionSpec``'s normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def spec_for(mesh, path: str, shape: Tuple[int, ...],
             no_fsdp: bool = False) -> Spec:
    """Right-align the first matching rule template; drop non-divisible axes."""
    ndim = len(shape)
    for pat, template in RULES:
        if not re.search(pat, path):
            continue
        if len(template) > ndim:
            continue
        # 4D expert rule must not hijack 3D dense ffn (and vice versa): take
        # the first template whose length <= ndim; expert rules are listed
        # after dense so 3D matches dense.
        axes = [None] * (ndim - len(template)) + list(template)
        spec = []
        for dim, logical in zip(shape, axes):
            phys = _resolve(mesh, logical, no_fsdp)
            if phys is None or dim % _axis_size(mesh, phys) != 0:
                spec.append(None)
            else:
                spec.append(phys)
        # a mesh axis may shard one dimension only: keep its first use
        used = set()
        clean = []
        for s in spec:
            if any(a in used for a in _flat_axes(s)):
                clean.append(None)
            else:
                used.update(_flat_axes(s))
                clean.append(s)
        return spec_of(clean)
    return (None,) * ndim


def param_specs(mesh, params_shape: Any, *, no_fsdp: bool = False,
                embed_tp: bool = False) -> Any:
    """Tree of specs matching a params (or train-state) tree of tensors.

    no_fsdp: replicate the data axes (TP-only / pure-DP) — serving layouts
    and small models where per-step weight all-gathers dominate.
    embed_tp: shard the embedding table on d_model over 'model' instead of
    vocab.
    A ``Packed8`` moment gets one spec for both of its arrays (``q`` and
    ``s``, each (blocks, ...)): the block dim over every mesh axis.
    """
    from repro_torch.core.pruning import _flatten, _unflatten
    from repro_torch.train.optimizer import Packed8
    flat = _flatten(params_shape)
    names = tuple(mesh_axes(mesh))
    specs = {}
    for path, leaf in flat.items():
        if isinstance(leaf, Packed8):
            # moments join no matmul, so shard the block dim over EVERY axis
            all_axes = names if not no_fsdp else \
                tuple(a for a in names if a == "model")
            nblk = leaf.q.shape[0]
            if all_axes and nblk % _axis_size(mesh, all_axes) == 0:
                specs[path] = spec_of([all_axes])
            else:
                specs[path] = ()
            continue
        shape = tuple(leaf.shape)
        if embed_tp and re.search(r"(^|/)embed$", path) and len(shape) == 2:
            tp = "model" if "model" in names else None
            ok = tp and shape[1] % _axis_size(mesh, tp) == 0
            specs[path] = (None, tp if ok else None)
            continue
        # disambiguate 3D dense-FFN vs 4D expert weights: both match
        # r"ffn/w_gate$" — the template is right-aligned, so the 3-entry
        # expert template on a 3D (L,d,f) dense weight would wrongly shard L.
        if re.search(r"ffn/(w_gate|w_up|w_down)$", path) and len(shape) == 4:
            tmpl = ("experts", "fsdp", "tp") if path.endswith(("w_gate", "w_up")) \
                else ("experts", "tp", "fsdp")
            axes = [None] * (len(shape) - 3) + list(tmpl)
            spec = []
            used = set()
            for dim, logical in zip(shape, axes):
                phys = _resolve(mesh, logical, no_fsdp)
                if phys is None or dim % _axis_size(mesh, phys) != 0 or \
                        any(a in used for a in _flat_axes(phys)):
                    spec.append(None)
                else:
                    used.update(_flat_axes(phys))
                    spec.append(phys)
            specs[path] = spec_of(spec)
        else:
            specs[path] = spec_for(mesh, path, shape, no_fsdp)
    return _unflatten(specs)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` for the tensor dimension d whose entry names it, else
    ``Replicate()``. A dimension sharded over several mesh axes is split in
    mesh order (major first), which is DTensor's default order and the
    order of the reference's tuples; a tuple out of mesh order would need
    DTensor's strided sharding, which no rule asks for. A mesh dimension of
    size 1 holds the whole tensor whichever way, and gets ``Replicate()``:
    every DTensor rule accepts it, where some view rules refuse to flatten a
    dimension sharded over a mesh dimension of any size."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _flat_axes(entry)
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), f"spec entry {entry} is not in mesh order"
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """``tree`` (tensors on ``mesh``'s device type, the same on every rank)
    laid out as ``DTensor``s by a matching tree of specs, a ``Packed8``'s
    ``q`` and ``s`` alike. Each rank keeps its own shard of its own copy: no
    collective runs. A local shard may share memory with the tensor it was
    cut from (the whole tensor, on a mesh of one rank), so an update of one
    in place shows in the other."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.train.optimizer import Packed8, tree_map

    def put(x, spec):
        if isinstance(x, Packed8):
            return Packed8(put(x.q, spec), put(x.s, spec), x.shape)
        return distribute_tensor(x, mesh, placements(mesh, spec),
                                 src_data_rank=None)
    return tree_map(put, tree, specs)


def shardings_for(mesh, tree_shape: Any) -> Any:
    """``(mesh, placements)`` for each leaf of ``tree_shape`` by
    ``param_specs`` (the reference's ``NamedSharding`` tree)."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda s: (mesh, placements(mesh, s)),
                    param_specs(mesh, tree_shape))


def batch_spec(mesh, batch_shape: Any, dp_axes=None) -> Any:
    """tokens/images/labels: batch dim over ('pod','data') when divisible.
    dp_axes overrides the data-parallel axes (dp_all layouts)."""
    from repro_torch.train.optimizer import tree_map
    dp = dp_axes or tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    dp_size = _axis_size(mesh, dp)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % dp_size == 0 and dp_size > 1:
            return spec_of([dp] + [None] * (len(shape) - 1))
        return (None,) * len(shape)
    return tree_map(one, batch_shape)


def cache_spec(mesh, cache_shape: Any, batch_axis: int = 1) -> Any:
    """KV caches / recurrent states: shard batch if divisible, else the
    longest remaining dim that divides (sequence for long-context B=1)."""
    from repro_torch.train.optimizer import tree_map
    names = tuple(mesh_axes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = _axis_size(mesh, dp)
    tp_size = _axis_size(mesh, "model")

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if not shape:
            return ()
        used_dp = False
        for i, dim in enumerate(shape):
            if not used_dp and dim % dp_size == 0 and dp_size > 1 and \
                    i >= min(batch_axis, len(shape) - 1) and dim >= dp_size:
                spec[i] = dp
                used_dp = True
                break
        if "model" in names and tp_size > 1:
            # shard the largest not-yet-sharded dim divisible by tp (sequence
            # for long caches); sharding head_dim instead makes every decode
            # attention contract over a sharded axis
            cands = [(dim, i) for i, dim in enumerate(shape)
                     if spec[i] is None and dim % tp_size == 0
                     and dim >= tp_size and i > 0]
            if cands:
                _, i = max(cands)
                spec[i] = "model"
        return spec_of(spec)
    return tree_map(one, cache_shape)
