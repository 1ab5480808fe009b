"""RWKV6 "Finch": attention-free linear RNN with data-dependent decay.

Time-mix implements the Finch recurrence per head (state S in R^{hd x hd}):
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w0 + lora_w(x_t)))
with ddlerp token-shift mixing. The recurrence is a Python loop over time
(exact, float32 state). O(1) decode state.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import shard
from repro_torch.models.common import (act_clip, dense_init, dtype_of,
                                       embed_init, remat_fn, rmsnorm,
                                       softmax_xent, unstack_layers)
from repro_torch.models.transformer import _cast, _embed, _layer_taus

MIX_KEYS = ("w", "k", "v", "r", "g")
# top-level leaves read in float32 whatever the compute dtype
READ_IN_FLOAT32 = ("final_norm",)


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"
                ) -> Dict[str, Any]:
    """Float32 parameters drawn from ``gen`` and placed on ``device``."""
    d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
    rw = cfg.rwkv
    H, hd = d // rw.head_dim, rw.head_dim

    def w(shape, **kw):
        return dense_init(gen, shape, device=device, **kw)

    def const(v, *shape):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    blocks = {
        "ln1": const(1.0, L, d), "ln2": const(1.0, L, d),
        # ddlerp token-shift
        "mu_base": const(0.0, L, d),
        "mix_w1": w((L, d, 5 * rw.mix_lora)),
        "mix_w2": w((L, 5, rw.mix_lora, d), in_axis=-2),
        "mu": const(0.0, L, 5, d),
        # projections
        "wr": w((L, d, d)),
        "wk": w((L, d, d)),
        "wv": w((L, d, d)),
        "wg": w((L, d, d)),
        "wo": w((L, d, d)),
        # data-dependent decay
        "w0": const(-4.0, L, d),
        "decay_a": w((L, d, rw.decay_lora)),
        "decay_b": w((L, rw.decay_lora, d)),
        "u": const(0.0, L, H, hd),           # per-head bonus
        "ln_x": const(1.0, L, d),            # per-head group norm scale
        # channel-mix
        "cm_mu_k": const(0.0, L, d),
        "cm_mu_r": const(0.0, L, d),
        "cm_wk": w((L, d, f)),
        "cm_wv": w((L, f, d)),
        "cm_wr": w((L, d, d)),
    }
    return {
        "embed": embed_init(gen, (cfg.vocab_size, d), device=device),
        "blocks": blocks,
        "final_norm": const(1.0, d),
        "lm_head": w((d, cfg.vocab_size)),
    }


def _ddlerp(p, x, sx):
    """Finch data-dependent token-shift. x, sx: (B,S,d)."""
    dx = sx - x
    base = x + dx * p["mu_base"]
    low = torch.tanh(base @ p["mix_w1"])                     # (B,S,5*ml)
    B_, S_, _ = low.shape
    low = low.reshape(B_, S_, 5, -1)
    offs = torch.einsum("bsfm,fmd->bsfd", low, p["mix_w2"])  # (B,S,5,d)
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu"][None, None] + offs)
    return {k: mixed[:, :, i] for i, k in enumerate(MIX_KEYS)}


def _decay(p, xw):
    return torch.exp(-torch.exp(
        (p["w0"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
         ).to(torch.float32)))


def _time_mix(p, x, cfg, state):
    """x: (B,S,d). state: {'sx': (B,d), 'S': (B,H,hd,hd)} carried across calls."""
    B, S, d = x.shape
    rw = cfg.rwkv
    H, hd = d // rw.head_dim, rw.head_dim
    f32 = torch.float32
    sx = torch.cat([state["sx"][:, None], x[:, :-1]], dim=1)
    m = _ddlerp(p, x, sx)
    r = (m["r"] @ p["wr"]).reshape(B, S, H, hd)
    k = (m["k"] @ p["wk"]).reshape(B, S, H, hd)
    v = (m["v"] @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(m["g"] @ p["wg"])
    w = _decay(p, m["w"]).reshape(B, S, H, hd)               # f32 in (0,1)
    u = p["u"]

    Sst = state["S"]
    outs = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].to(f32), v[:, t].to(f32))
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(f32),
                                 Sst + u[None, :, :, None] * kv))
        Sst = w[:, t, ..., None] * Sst + kv
    y = torch.stack(outs, dim=1).reshape(B, S, d).to(x.dtype)
    # per-head group norm
    y = rmsnorm(y.reshape(B, S, H, hd),
                p["ln_x"].reshape(H, hd), cfg.norm_eps).reshape(B, S, d)
    y = (y * g) @ p["wo"]
    return y, {"sx": x[:, -1], "S": Sst}


def _channel_mix(p, x, state, act_tau=None):
    sx = torch.cat([state["sx"][:, None], x[:, :-1]], dim=1)
    dx = sx - x
    xk = act_clip(x + dx * p["cm_mu_k"], act_tau)
    xr = x + dx * p["cm_mu_r"]
    kk = torch.relu(xk @ p["cm_wk"]).square()
    kk = shard(kk, "batch", None, "ff")
    out = torch.sigmoid(xr @ p["cm_wr"]) * (act_clip(kk, act_tau) @ p["cm_wv"])
    return out, {"sx": x[:, -1]}


def init_state(cfg: ModelConfig, B: int, device="cuda"):
    d = cfg.d_model
    rw = cfg.rwkv
    H, hd = d // rw.head_dim, rw.head_dim
    L = cfg.num_layers
    dt = dtype_of(cfg.dtype)
    return {
        "att_sx": torch.zeros((L, B, d), dtype=dt, device=device),
        "ffn_sx": torch.zeros((L, B, d), dtype=dt, device=device),
        "S": torch.zeros((L, B, H, hd, hd), dtype=torch.float32,
                         device=device),
        "pos": torch.zeros((B,), dtype=torch.int64, device=device),
    }


def forward(cfg: ModelConfig, params, tokens, *, state=None, sparsity=None,
            remat=None):
    """Returns (logits, new_state). state=None -> zeros (training). Any
    ``remat`` checkpoints each block whole for the backward pass, as the
    JAX package does."""
    dt = dtype_of(cfg.dtype)
    B, S = tokens.shape
    if state is None:
        state = init_state(cfg, B, device=tokens.device)
    h = _embed(params, tokens, dt)
    h = shard(h, "batch", None, "embed")

    def block(p, h, taus, att_sx, S_i, ffn_sx):
        p = _cast(p, dt)
        f_tau = taus.get("ffn") if taus else None
        a_tau = taus.get("attn") if taus else None
        x = rmsnorm(h, p["ln1"], cfg.norm_eps)
        x = act_clip(x, a_tau)
        y, att_st = _time_mix(p, x, cfg, {"sx": att_sx, "S": S_i})
        h = h + y
        x = rmsnorm(h, p["ln2"], cfg.norm_eps)
        y, ffn_st = _channel_mix(p, x, {"sx": ffn_sx}, f_tau)
        return h + y, att_st["sx"], att_st["S"], ffn_st["sx"]

    block = remat_fn(block, "full" if remat else None)
    att_sx, ffn_sx, S_all = [], [], []
    for i, p in enumerate(unstack_layers(params["blocks"])):
        h, a_sx, S_i, f_sx = block(p, h, _layer_taus(sparsity, i),
                                   state["att_sx"][i], state["S"][i],
                                   state["ffn_sx"][i])
        att_sx.append(a_sx)
        S_all.append(S_i)
        ffn_sx.append(f_sx)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ params["lm_head"].to(dt)            # untied, whatever cfg says
    logits = shard(logits, "batch", None, "vocab")
    new_state = {"att_sx": torch.stack(att_sx), "ffn_sx": torch.stack(ffn_sx),
                 "S": torch.stack(S_all), "pos": state["pos"] + S}
    return logits, new_state


def loss(cfg: ModelConfig, params, batch, *, sparsity=None, remat=None):
    tokens = batch["tokens"]
    logits, _ = forward(cfg, params, tokens, sparsity=sparsity, remat=remat)
    l = softmax_xent(logits[:, :-1], tokens[:, 1:]).mean()
    return l, {"xent": l}


def prefill(cfg: ModelConfig, params, tokens, S_max: int, **kw):
    logits, state = forward(cfg, params, tokens)
    return logits[:, -1:], state


def decode_step(cfg: ModelConfig, params, state, token):
    return forward(cfg, params, token, state=state)
