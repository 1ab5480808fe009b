"""Mixture-of-Experts FFN with capacity-based sort dispatch.

Sort-based dispatch (sort the token slots by expert, write them into a fixed
(E, C, d) buffer) keeps memory at E*C*d instead of the T*E*C one-hot blowup.
Slots beyond an expert's capacity C are dropped (standard capacity
semantics); the router's aux loss keeps the load balanced so drops stay rare.

Every step is deterministic on the card: the top-k breaks ties by the lower
expert index (as ``jax.lax.top_k`` does), the dispatch writes each kept slot
to its own buffer row (no accumulation), and the combine gathers each token's
k expert outputs and adds them in expert order, the order in which the JAX
package's scatter-add on the CPU adds them. There is no atomic addition.

On a mesh, ``REPRO_MOE_SHARDMAP=1`` routes the experts through
``_shard_map_dispatch`` (expert parallelism over 'model', see there).
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import act_clip, activation


def capacity(T: int, moe: MoEConfig) -> int:
    c = int(moe.capacity_factor * T * moe.top_k / moe.num_experts)
    return max(8, -(-c // 8) * 8)                       # round up to 8


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row; among equal
    values the lower index comes first (a stable descending sort)."""
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], order[:, :k]


def route(x, router_w, moe: MoEConfig):
    """x: (T, d) -> gates (T, k), expert ids (T, k), aux loss. In float32."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, moe.top_k)               # (T,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    me = probs.mean(dim=0)                                          # (E,)
    # tokens per expert as the JAX package counts them (zeros(E).at[idx]
    # .add(1)): integer-valued float32 sums, exact in any order, and no
    # read of the indices on the host (bincount sizes its output from their
    # maximum), so a CUDA graph can capture it
    flat = idx.reshape(-1)
    ce = torch.zeros(moe.num_experts, dtype=torch.float32,
                     device=idx.device).scatter_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=idx.device)) / idx.numel()
    aux = moe.num_experts * torch.sum(me * ce) * moe.aux_loss_coef
    return gates, idx, aux


def group_positions(se: torch.Tensor, E: int) -> torch.Tensor:
    """Each slot's position within its expert's group, for slots sorted by
    expert (``se``, values in [0, E)): its rank less the expert's first
    rank. The reference takes that first rank by a scatter-min of the
    ranks; in sorted order it is the number of slots of a smaller expert,
    the exclusive cumsum of the per-expert counts (ops that DTensor can
    shard, and no read on the host)."""
    counts = torch.zeros(E, dtype=torch.int64, device=se.device).scatter_add(
        0, se, torch.ones_like(se))
    group_start = torch.cumsum(counts, 0) - counts
    return torch.arange(se.shape[0], device=se.device) - \
        group_start.gather(0, se)


def dispatch_combine(x, gates, idx, moe: MoEConfig, expert_fn,
                     n_buckets: int = 0, cap: int = 0):
    """Run expert_fn over a capacity-bounded (E, C, d) buffer.

    x: (T, d); gates/idx: (T, k); expert_fn: (E, C, d) -> (E, C, d_out).
    n_buckets/cap override the bucket count and per-bucket capacity (used by
    the expert-parallel dispatch, where the last bucket is a drop bucket).
    """
    T, d = x.shape
    k, E = moe.top_k, n_buckets or moe.num_experts
    C = cap or capacity(T, moe)
    dev = x.device

    slot_expert = idx.reshape(T * k)                    # (T*k,)
    slot_token = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    slot_gate = gates.reshape(T * k)

    order = torch.argsort(slot_expert, stable=True)    # group by expert
    se, st, sg = slot_expert[order], slot_token[order], slot_gate[order]
    pos = group_positions(se, E)
    keep = pos < C

    # each kept slot owns one buffer row; dropped slots all land on a spare
    # row past the end, which is cut off
    rows = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((rows,), x[st])
    buf = buf[:E * C].view(E, C, d)
    if os.environ.get("REPRO_MOE_SHARD_CAP", "0") == "1":
        # shard the capacity dim over the data axes too
        from repro_torch.distributed.ctx import shard
        buf = shard(buf, "experts", "batch", None)
    out_buf = expert_fn(buf)                            # (E, C, d_out)

    gathered = out_buf[se, torch.clamp(pos, max=C - 1)]  # (T*k, d_out)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    contrib = torch.empty((T * k, out_buf.shape[-1]), dtype=torch.float32,
                          device=dev).index_put(
        (order,), gathered.to(torch.float32) * sg[:, None])
    # each token's k contributions, summed in expert order
    per_tok = contrib.view(T, k, -1).gather(
        1, torch.argsort(idx, dim=1)[..., None].expand(T, k, contrib.shape[-1]))
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out.to(x.dtype)


def moe_ffn(x, p, moe: MoEConfig, act_name: str = "silu", act_tau=None):
    """x: (T, d). p: {'router': (d,E), 'w_gate','w_up': (E,d,f), 'w_down': (E,f,d),
    optional 'shared_*' dense expert}."""
    act = activation(act_name)
    gates, idx, aux = route(x, p["router"], moe)

    if os.environ.get("REPRO_MOE_SHARDMAP", "0") == "1":
        y = _shard_map_dispatch(act_clip(x, act_tau), gates, idx, p, moe,
                                act, act_tau)
        if y is not None:
            if "shared_w_gate" in p:
                h = act(x @ p["shared_w_gate"]) * (x @ p["shared_w_up"])
                y = y + act_clip(h, act_tau) @ p["shared_w_down"]
            return y, aux

    def experts(buf):                                   # (E, C, d)
        h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        h = act_clip(h, act_tau)
        return torch.bmm(h, p["w_down"])

    y = dispatch_combine(act_clip(x, act_tau), gates, idx, moe, experts)
    if "shared_w_gate" in p:
        h = act(x @ p["shared_w_gate"]) * (x @ p["shared_w_up"])
        y = y + act_clip(h, act_tau) @ p["shared_w_down"]
    return y, aux


def _shard_map_dispatch(x, gates, idx, p, moe: MoEConfig, act, act_tau):
    """Expert-parallel dispatch on a (data, model) mesh, over each rank's
    local shards (the reference's shard_map body).

    Activations are replicated over the 'model' axis (batch shards over the
    data axes), so each model column *locally* selects the tokens routed to
    its own E/n experts — no token all-to-all exists in this layout at all:
      * expert weights arrive ('model', fsdp)-sharded; the fsdp dim is
        all-gathered inside (the ordinary FSDP cost),
      * tokens with experts outside the column fall into a drop bucket at
        index E_loc,
      * partial outputs are summed over 'model' (the same collective a dense
        TP FFN pays).
    Operands are ``DTensor``s on the context's mesh (a plain tensor is taken
    as replicated); each is laid out as the reference's in_specs say, then
    worked on locally. Returns the (T, d) ``DTensor`` batch-sharded over the
    data axes, or None when the layout does not apply (no context, no
    'model' axis or one of size 1, E % model, T % dp), where the reference
    returns None.
    """
    import torch.distributed.nn.functional as dfn
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed import ctx as _ctx
    from repro_torch.distributed.sharding import mesh_axes, placements

    c = _ctx.current()
    if c is None:
        return None
    sizes = mesh_axes(c.mesh)
    n_model = sizes.get("model", 1)
    E = moe.num_experts
    if n_model <= 1 or E % n_model:
        return None
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    T, d = x.shape
    ndp = math.prod(sizes[a] for a in dp)
    if T % ndp:
        return None
    mesh = c.mesh
    E_loc = E // n_model
    T_loc = T // ndp
    C = capacity_for(T_loc, moe)

    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    fsdp_w = dp if (dp and wg.shape[1] % ndp == 0) else ()
    xspec = (dp if dp else None, None)
    wspec = ("model", fsdp_w if fsdp_w else None, None)
    wdspec = ("model", None, fsdp_w if fsdp_w else None)

    def local(t, spec):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements(mesh, spec)).to_local()

    def gather_fsdp(w, dim):
        # tiled all-gather over the fsdp axes, major first: the innermost
        # axis's shards are joined first
        for a in reversed(fsdp_w):
            w = torch.cat(dfn.all_gather(w.contiguous(),
                                         group=mesh.get_group(a)), dim=dim)
        return w

    x_l, g_l, i_l = (local(t, xspec) for t in (x, gates, idx))
    wg_l, wu_l, wd_l = local(wg, wspec), local(wu, wspec), local(wd, wdspec)
    if fsdp_w:
        wg_l, wu_l, wd_l = (gather_fsdp(wg_l, 1), gather_fsdp(wu_l, 1),
                            gather_fsdp(wd_l, 2))
    j = mesh.get_local_rank("model")
    il = i_l - j * E_loc
    valid = (il >= 0) & (il < E_loc)
    il = torch.where(valid, il, torch.full_like(il, E_loc))   # drop bucket
    gl = torch.where(valid, g_l, torch.zeros_like(g_l))

    def experts(buf):                                  # (E_loc+1, C, d)
        h = act(torch.bmm(buf[:E_loc], wg_l)) * torch.bmm(buf[:E_loc], wu_l)
        h = act_clip(h, act_tau)
        out = torch.bmm(h, wd_l)
        return torch.cat([out, torch.zeros((1,) + out.shape[1:],
                                           dtype=out.dtype,
                                           device=out.device)], dim=0)

    y_part = dispatch_combine(x_l, gl, il, moe, experts,
                              n_buckets=E_loc + 1, cap=C)
    y = dfn.all_reduce(y_part, group=mesh.get_group("model"))
    return DTensor.from_local(y, mesh, placements(mesh, xspec),
                              run_check=False)


def capacity_for(T_local: int, moe: MoEConfig) -> int:
    c = int(moe.capacity_factor * T_local * moe.top_k / moe.num_experts)
    return max(8, -(-c // 8) * 8)
