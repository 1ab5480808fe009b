"""Mamba2 (SSD) blocks and the Zamba2 hybrid (Mamba2 + shared attention).

Mamba2 recurrence per head h (state in R^{hd x N}):
    a_t = exp(-dt_t * exp(A_log))            (scalar per head)
    H_t = a_t * H_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = H_t · C_t + D ⊙ x_t
with a depthwise causal conv (width 4) in front of x/B/C and a silu(z) gate.
The recurrence is a Python loop over time (exact, float32 state).

Zamba2 applies one *shared* (weight-tied) full-attention transformer block
every ``hybrid_attn_every`` mamba layers; its input is proj(concat(h, h_emb0))
per the Zamba recipe (per-invocation LoRA omitted, as in the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import shard
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (act_clip, dense_init, dtype_of,
                                       embed_init, remat_fn, rmsnorm,
                                       softmax_xent, take_layer,
                                       unstack_layers)

Params = Dict[str, Any]

# top-level leaves read in float32 whatever the compute dtype
READ_IN_FLOAT32 = ("final_norm",)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.state_dim, s.conv_dim


def init_mamba_params(cfg: ModelConfig, gen, L: int, device) -> Params:
    d = cfg.d_model
    d_in, H, hd, N, K = _dims(cfg)
    conv_ch = d_in + 2 * N

    def const(v, *shape):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {
        "ln": const(1.0, L, d),
        "in_proj": dense_init(gen, (L, d, 2 * d_in + 2 * N + H), device=device),
        "conv_w": dense_init(gen, (L, K, conv_ch), in_axis=-2, device=device),
        "conv_b": const(0.0, L, conv_ch),
        "A_log": const(0.0, L, H),
        "D": const(1.0, L, H),
        "dt_bias": const(0.0, L, H),
        "out_norm": const(1.0, L, d_in),
        "out_proj": dense_init(gen, (L, d_in, d), device=device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x:(B,S,C), w:(K,C). state:(B,K-1,C) or None."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B,S+K-1,C)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    return F.silu(out), xp[:, -(K - 1):]                     # new conv state


def mamba_block(p, x, cfg: ModelConfig, state=None, act_tau=None):
    """x: (B,S,d). state: {'conv': (B,K-1,C), 'ssm': (B,H,hd,N)} or None.
    Returns (out, new_state)."""
    B, S, d = x.shape
    d_in, H, hd, N, K = _dims(cfg)
    f32 = torch.float32
    x = act_clip(x, act_tau)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = zxbcdt.split([d_in, d_in + 2 * N, H], dim=-1)
    conv_state = state["conv"] if state else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bc, Cc = xbc.split([d_in, N, N], dim=-1)
    xs = xs.reshape(B, S, H, hd)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                     # (B,S,H)
    a = torch.exp(-dt * torch.exp(p["A_log"]))                      # (B,S,H)
    dx = dt[..., None] * xs.to(f32)                                 # (B,S,H,hd)

    Hst = state["ssm"] if state else torch.zeros((B, H, hd, N), dtype=f32,
                                                 device=x.device)
    ys = []
    for t in range(S):
        Hst = a[:, t, :, None, None] * Hst + \
            torch.einsum("bhd,bn->bhdn", dx[:, t], Bc[:, t].to(f32))
        ys.append(torch.einsum("bhdn,bn->bhd", Hst, Cc[:, t].to(f32)))
    y = torch.stack(ys, dim=1)                                      # (B,S,H,hd)
    y = y + p["D"][:, None] * xs.to(f32)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    y = shard(y, "batch", None, "ff")
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": Hst}


# --------------------------------------------------------------------- #
# Zamba2 hybrid model
# --------------------------------------------------------------------- #
def _n_shared(cfg: ModelConfig) -> int:
    return -(-cfg.num_layers // cfg.hybrid_attn_every)      # ceil


def _groups(cfg: ModelConfig):
    """The mamba layer ranges [lo, hi) that follow each shared-attention
    call site (one range without a call site when there is none)."""
    k, L = cfg.hybrid_attn_every, cfg.num_layers
    if not k:
        return [(0, L)]
    return [(g * k, min((g + 1) * k, L)) for g in range(_n_shared(cfg))]


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"
                ) -> Params:
    """Float32 parameters drawn from ``gen`` and placed on ``device``."""
    p: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), device=device),
        "mamba": init_mamba_params(cfg, gen, cfg.num_layers, device),
        "final_norm": torch.ones((cfg.d_model,), device=device),
    }
    if cfg.hybrid_attn_every:
        p["shared"] = tfm._block_params(gen, cfg, 1, device)  # one weight-tied block
        p["shared_proj"] = dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                      device=device)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  device=device)
    return p


def _shared_attn(cfg, params, h, h0, rot, k_buf=None, v_buf=None,
                 pos=None, return_kv_eff=0):
    """Apply the weight-tied attention block. With ``k_buf``/``v_buf`` (this
    call site's KV cache, written in place) it decodes one token at ``pos``.
    return_kv_eff>0 (prefill): also return the last ``eff`` K/V rows,
    right-padded — the cache for this call site."""
    dt = h.dtype
    p = tfm._cast(take_layer(params["shared"], 0), dt)
    z = torch.cat([h, h0], dim=-1) @ params["shared_proj"].to(dt)
    x = rmsnorm(z, p["ln1"], cfg.norm_eps)
    kv = None
    if k_buf is None:
        o = tfm.attention_block(p["attn"], x, cfg, rot, causal=True)
        if return_kv_eff:
            _, kk, vv = tfm._gqa_qkv(p["attn"], x, cfg, rot)
            kv = (tfm._to_cache(kk, return_kv_eff),
                  tfm._to_cache(vv, return_kv_eff))
    else:
        o = tfm._gqa_decode_attn(p["attn"], x, cfg, k_buf, v_buf, pos, rot)
    x2 = rmsnorm(z + o, p["ln2"], cfg.norm_eps)
    y, _ = tfm.ffn_block(p["ffn"], x2, cfg)
    return h + z + o + y, kv


def forward(cfg: ModelConfig, params, tokens, *, sparsity=None, remat=None,
            return_state=False, S_max: int = 0):
    """Logits (B,S,V); with ``return_state`` also the decode state after the
    last token (mamba conv/ssm finals + windowed shared-attention KV).
    Any ``remat`` checkpoints each mamba layer whole for the backward pass
    (the shared attention block is not checkpointed), as the JAX package
    does."""
    dt = dtype_of(cfg.dtype)
    B, S = tokens.shape
    h = tfm._embed(params, tokens, dt)
    h = shard(h, "batch", None, "embed")
    h0 = h
    rot = tfm.rope(cfg, torch.arange(S, device=tokens.device))
    k = cfg.hybrid_attn_every
    eff = min(S_max or S, 4096)

    def mamba_step(p, h, f_tau):
        p = tfm._cast(p, dt)
        y, st = mamba_block(p, rmsnorm(h, p["ln"], cfg.norm_eps), cfg,
                            act_tau=f_tau)
        return h + y, st["conv"], st["ssm"]

    mamba_step = remat_fn(mamba_step, "full" if remat else None)
    layers = unstack_layers(params["mamba"])
    convs, ssms, attn_kv = [], [], []
    for (lo, hi) in _groups(cfg):
        if k:
            h, kv = _shared_attn(cfg, params, h, h0, rot,
                                 return_kv_eff=eff if return_state else 0)
            attn_kv.append(kv)
        for i in range(lo, hi):
            f_tau = (tfm._layer_taus(sparsity, i) or {}).get("ffn")
            h, conv, ssm_st = mamba_step(layers[i], h, f_tau)
            convs.append(conv)
            ssms.append(ssm_st)
    # tfm.unembed constrains the logits to ("batch", None, "vocab")
    logits = tfm.unembed(cfg, params,
                         rmsnorm(h, params["final_norm"], cfg.norm_eps))
    if not return_state:
        return logits
    st = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
          "pos": torch.full((B,), S, dtype=torch.int64, device=tokens.device)}
    if k:
        st["attn_k"] = torch.stack([kv[0] for kv in attn_kv])
        st["attn_v"] = torch.stack([kv[1] for kv in attn_kv])
    return logits, st


def prefill(cfg: ModelConfig, params, tokens, S_max: int, **kw):
    """Parallel prefill: one forward over the prompt, states collected per
    layer (mamba conv/ssm finals + windowed shared-attn KV)."""
    B, S = tokens.shape
    eff = min(S_max, 4096) if cfg.hybrid_attn_every else S_max
    assert S <= eff or S % eff == 0, (S, eff)
    logits, state = forward(cfg, params, tokens, return_state=True,
                            S_max=S_max)
    return logits[:, -1:], state


def loss(cfg: ModelConfig, params, batch, *, sparsity=None, remat=None):
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens, sparsity=sparsity, remat=remat)
    l = softmax_xent(logits[:, :-1], tokens[:, 1:]).mean()
    return l, {"xent": l}


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #
def init_state(cfg: ModelConfig, B: int, S_max: int, device="cuda"):
    d_in, H, hd, N, K = _dims(cfg)
    L = cfg.num_layers
    dt = dtype_of(cfg.dtype)
    st = {
        "conv": torch.zeros((L, B, K - 1, d_in + 2 * N), dtype=dt,
                            device=device),
        "ssm": torch.zeros((L, B, H, hd, N), dtype=torch.float32,
                           device=device),
        "pos": torch.zeros((B,), dtype=torch.int64, device=device),
    }
    if cfg.hybrid_attn_every:
        n = _n_shared(cfg)
        KV, ahd = cfg.num_kv_heads, cfg.resolved_head_dim
        eff = min(S_max, 4096)          # shared-attn KV windowed for long ctx
        st["attn_k"] = torch.zeros((n, B, eff, KV, ahd), dtype=dt,
                                   device=device)
        st["attn_v"] = torch.zeros((n, B, eff, KV, ahd), dtype=dt,
                                   device=device)
    return st


def decode_step(cfg: ModelConfig, params, state, token):
    """One token. The shared-attention KV caches are written in place; the
    mamba states of the returned dict are new tensors."""
    dt = dtype_of(cfg.dtype)
    h = tfm._embed(params, token, dt)
    pos = state["pos"]
    h0 = h                 # Zamba: shared block sees the current-token embedding
    k = cfg.hybrid_attn_every
    rot = tfm.rope(cfg, pos[:, None]) if k else None
    convs, ssms = [], []
    for gi, (lo, hi) in enumerate(_groups(cfg)):
        if k:
            h, _ = _shared_attn(cfg, params, h, h0, rot,
                                k_buf=state["attn_k"][gi],
                                v_buf=state["attn_v"][gi], pos=pos)
        for i in range(lo, hi):
            p = tfm._cast(take_layer(params["mamba"], i), dt)
            y, st = mamba_block(p, rmsnorm(h, p["ln"], cfg.norm_eps), cfg,
                                state={"conv": state["conv"][i],
                                       "ssm": state["ssm"][i]})
            h = h + y
            convs.append(st["conv"])
            ssms.append(st["ssm"])
    new_state = dict(state)
    new_state.update(conv=torch.stack(convs), ssm=torch.stack(ssms),
                     pos=pos + 1)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, h), new_state
