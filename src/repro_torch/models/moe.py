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
"""
from __future__ import annotations

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
    ce = torch.bincount(idx.reshape(-1), minlength=moe.num_experts
                        ).to(torch.float32) / idx.numel()
    aux = moe.num_experts * torch.sum(me * ce) * moe.aux_loss_coef
    return gates, idx, aux


def dispatch_combine(x, gates, idx, moe: MoEConfig, expert_fn):
    """Run expert_fn over a capacity-bounded (E, C, d) buffer.

    x: (T, d); gates/idx: (T, k); expert_fn: (E, C, d) -> (E, C, d_out).
    """
    T, d = x.shape
    k, E = moe.top_k, moe.num_experts
    C = capacity(T, moe)
    dev = x.device

    slot_expert = idx.reshape(T * k)                    # (T*k,)
    slot_token = torch.arange(T, device=dev).repeat_interleave(k)
    slot_gate = gates.reshape(T * k)

    order = torch.argsort(slot_expert, stable=True)    # group by expert
    se, st, sg = slot_expert[order], slot_token[order], slot_gate[order]
    # position within expert group = rank - first rank of the expert
    ranks = torch.arange(T * k, device=dev)
    pos = ranks - torch.searchsorted(se, se)
    keep = pos < C

    # each kept slot owns one buffer row; dropped slots all land on a spare
    # row past the end, which is cut off
    rows = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[rows] = x[st]
    out_buf = expert_fn(buf[:E * C].view(E, C, d))      # (E, C, d_out)

    gathered = out_buf[se, torch.clamp(pos, max=C - 1)]  # (T*k, d_out)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    contrib = torch.empty((T * k, out_buf.shape[-1]), dtype=torch.float32,
                          device=dev)
    contrib[order] = gathered.to(torch.float32) * sg[:, None]
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

    def experts(buf):                                   # (E, C, d)
        h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        h = act_clip(h, act_tau)
        return torch.bmm(h, p["w_down"])

    y = dispatch_combine(act_clip(x, act_tau), gates, idx, moe, experts)
    if "shared_w_gate" in p:
        h = act(x @ p["shared_w_gate"]) * (x @ p["shared_w_up"])
        y = y + act_clip(h, act_tau) @ p["shared_w_down"]
    return y, aux
