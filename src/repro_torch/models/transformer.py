"""Decoder-only / encoder-decoder transformer LM over stacked layer params.

Covers the dense/GQA, qk-norm, QKV-bias, sliding-window, MLA (DeepSeek-V3),
MoE (Mixtral / DeepSeek-V3) and whisper (enc-dec) variants of the assigned
pool. Parameters are stacked over the layer axis, as in the JAX package, so
that a parameter tree converts array for array; the forward pass is a Python
loop over the layers.

Serving: ``prefill`` builds the KV cache and ``decode_step`` advances it one
token. The cache's buffers are written in place (one row per sequence per
layer) and the dict ``decode_step`` returns shares them with the one it was
given.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx as shard_ctx
from repro_torch.distributed.ctx import shard
from repro_torch.distributed.sharding import cache_spec, distribute
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import blockwise_attention, decode_attention
from repro_torch.models.common import (act_clip, activation, dense_init,
                                       dtype_of, embed_init, remat_fn,
                                       rmsnorm, rope_table, rotate,
                                       softmax_xent, take_layer,
                                       unstack_layers)

Params = Dict[str, Any]

# top-level leaves that prefill and decode read in float32 whatever the
# compute dtype (the final and encoder norms; the MTP head is read by the
# loss alone): ``models.serving_params`` casts every other float32 leaf
READ_IN_FLOAT32 = ("final_norm", "enc_norm", "mtp")


def _cast(p, dt):
    """Cast float32 master weights to the compute dtype at point of use (a
    no-op on a tree that is already in it)."""
    if isinstance(p, dict):
        return {k: _cast(v, dt) for k, v in p.items()}
    return p.to(dt) if p.dtype == torch.float32 else p


def _mm(a, b):
    """a @ b in the promoted dtype of the two (bf16 @ f32 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _embed(params, tokens, dt):
    """Rows of the embedding in the compute dtype (gathered, then cast).
    Tokens split over ranks take ``F.embedding`` on a table whose
    vocabulary is whole (the indexing rules of torch 2.11 refuse split
    tokens in the forward and backward, and DTensor's masked sum over a
    split vocabulary fails on split tokens); its backward sums the rows
    in another order than the indexing's on the card, so tokens held
    whole keep the indexing."""
    if shard_ctx.is_sharded(tokens) and any(
            p.is_shard() for p in tokens.placements):
        return F.embedding(tokens, shard_ctx.whole(params["embed"], 0)).to(dt)
    return params["embed"][tokens].to(dt)


def rope(cfg: ModelConfig, positions):
    """The rotary table of ``positions`` for this config's rotated head dim
    (MLA rotates only its ``qk_rope_head_dim`` part). Computed once per
    forward or decode step and shared by every layer."""
    d = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
        else cfg.resolved_head_dim
    return rope_table(positions, d, cfg.rope_theta)


def _layer_taus(sparsity, i):
    """Layer i's clip thresholds from per-layer stacked ones, or None."""
    if not sparsity:
        return None
    return {k: v[i] for k, v in sparsity.items()}


# ===================================================================== #
# Init
# ===================================================================== #
def _attn_params(gen, cfg: ModelConfig, L: int, device, cross: bool = False
                 ) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def w(shape, **kw):
        return dense_init(gen, shape, device=device, **kw)

    def ones(*shape):
        return torch.ones(shape, device=device)

    if cfg.mla is not None and not cross:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": w((L, d, m.q_lora_rank)),
            "q_norm_a": ones(L, m.q_lora_rank),
            "wq_b": w((L, m.q_lora_rank, H * qk_dim)),
            "wkv_a": w((L, d, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_norm_a": ones(L, m.kv_lora_rank),
            "wkv_b": w((L, m.kv_lora_rank,
                        H * (m.qk_nope_head_dim + m.v_head_dim))),
            "wo": w((L, H * m.v_head_dim, d)),
        }
    p = {
        "wq": w((L, d, H * hd)),
        "wk": w((L, d, KV * hd)),
        "wv": w((L, d, KV * hd)),
        "wo": w((L, H * hd, d)),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((L, H * hd), device=device)
        p["bk"] = torch.zeros((L, KV * hd), device=device)
        p["bv"] = torch.zeros((L, KV * hd), device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = ones(L, hd)
        p["k_norm"] = ones(L, hd)
    return p


def _ffn_params(gen, cfg: ModelConfig, L: int, device) -> Params:
    d = cfg.d_model

    def w(shape):
        return dense_init(gen, shape, device=device)

    if cfg.moe is not None:
        fe = cfg.moe.expert_d_ff or cfg.d_ff
        E = cfg.moe.num_experts
        p = {
            "router": w((L, d, E)),
            "w_gate": w((L, E, d, fe)),
            "w_up": w((L, E, d, fe)),
            "w_down": w((L, E, fe, d)),
        }
        if cfg.moe.num_shared_experts:
            fs = fe * cfg.moe.num_shared_experts
            p["shared_w_gate"] = w((L, d, fs))
            p["shared_w_up"] = w((L, d, fs))
            p["shared_w_down"] = w((L, fs, d))
        return p
    return {
        "w_gate": w((L, d, cfg.d_ff)),
        "w_up": w((L, d, cfg.d_ff)),
        "w_down": w((L, cfg.d_ff, d)),
    }


def _block_params(gen, cfg: ModelConfig, L: int, device, cross: bool = False
                  ) -> Params:
    p = {
        "ln1": torch.ones((L, cfg.d_model), device=device),
        "ln2": torch.ones((L, cfg.d_model), device=device),
        "attn": _attn_params(gen, cfg, L, device),
        "ffn": _ffn_params(gen, cfg, L, device),
    }
    if cross:
        p["ln_cross"] = torch.ones((L, cfg.d_model), device=device)
        p["cross"] = _attn_params(gen, cfg, L, device, cross=True)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"
                ) -> Params:
    """Float32 parameters drawn from ``gen`` and placed on ``device``."""
    L = cfg.num_layers
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), device=device),
        "blocks": _block_params(gen, cfg, L, device,
                                cross=cfg.is_encoder_decoder),
        "final_norm": torch.ones((cfg.d_model,), device=device),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       device=device)
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = _block_params(gen, cfg, cfg.enc_layers, device)
        params["enc_norm"] = torch.ones((cfg.d_model,), device=device)
        params["enc_pos"] = embed_init(gen, (cfg.num_frames, cfg.d_model),
                                       device=device)
        params["dec_pos"] = embed_init(gen, (4096, cfg.d_model), device=device)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                               device=device),
            "block": _block_params(gen, cfg, cfg.mtp_depth, device),
            "norm": torch.ones((cfg.d_model,), device=device),
        }
    return params


# ===================================================================== #
# Attention (one layer, expanded form for train/prefill)
# ===================================================================== #
def _gqa_qkv(p, h, cfg: ModelConfig, rot):
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard_ctx.reshape(q, B, S, H, hd)
    k = shard_ctx.reshape(k, B, S, KV, hd)
    v = shard_ctx.reshape(v, B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(q, *rot)
    k = rotate(k, *rot)
    return q, k, v


def _mla_qkv(p, h, cfg: ModelConfig, rot):
    """MLA expanded form. Returns q,k,v with head dims (nope+rope / v)."""
    m = cfg.mla
    B, S, _ = h.shape
    H = cfg.num_heads
    # the low-rank products held batch-sharded, their gradients too (a
    # sequence-sharded gradient cannot be flattened for the weight's)
    qa = rmsnorm(shard(h @ p["wq_a"], "batch", None, None), p["q_norm_a"],
                 cfg.norm_eps)
    q = shard_ctx.reshape(qa @ p["wq_b"], B, S, H,
                          m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = rotate(q_rope, *rot)

    kv_a = shard(h @ p["wkv_a"], "batch", None, None)     # (B,S,kvr+rd)
    ckv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rmsnorm(ckv, p["kv_norm_a"], cfg.norm_eps)
    k_rope = rotate(k_rope[:, :, None, :], *rot)          # shared head
    kv = shard_ctx.reshape(ckv @ p["wkv_b"], B, S, H,
                           m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, ckv, k_rope


def attention_block(p, h, cfg: ModelConfig, rot, *, causal=True,
                    attn_impl="blockwise_full", kv_override=None):
    """Self/cross attention sublayer (pre-norm residual outside)."""
    B, S, _ = h.shape
    if cfg.mla is not None and kv_override is None:
        q, k, v, _, _ = _mla_qkv(p, h, cfg, rot)
        o = blockwise_attention(q, k, v, causal=causal, window=cfg.attn_window,
                                impl=attn_impl)
        o = shard(shard_ctx.reshape(o, B, S, -1), "batch", None, "heads")
        return o @ p["wo"]
    if kv_override is not None:                          # cross attention
        xk, xv = kv_override
        H, hd = cfg.num_heads, cfg.resolved_head_dim
        q = shard_ctx.reshape(h @ p["wq"], B, S, H, hd)
        o = blockwise_attention(q, xk, xv, causal=False)
        return shard_ctx.reshape(o, B, S, -1) @ p["wo"]
    q, k, v = _gqa_qkv(p, h, cfg, rot)
    q = shard(q, "batch", None, "heads", None)
    o = blockwise_attention(q, k, v, causal=causal, window=cfg.attn_window,
                            impl=attn_impl)
    o = shard(shard_ctx.reshape(o, B, S, -1), "batch", None, "heads")
    return o @ p["wo"]


def ffn_block(p, h, cfg: ModelConfig, act_tau=None):
    B, S, d = h.shape
    if cfg.moe is not None:
        y, aux = moe_lib.moe_ffn(shard_ctx.reshape(h, B * S, d), p, cfg.moe,
                                 cfg.act, act_tau)
        return shard_ctx.reshape(y, B, S, d), aux
    act = activation(cfg.act)
    h_in = act_clip(h, act_tau)
    g = act(h_in @ p["w_gate"]) * (h_in @ p["w_up"])
    g = shard(g, "batch", None, "ff")
    g = act_clip(g, act_tau)
    return g @ p["w_down"], 0.0


# ===================================================================== #
# Forward (train / prefill share this; a loop over stacked layers)
# ===================================================================== #
def _block(cfg: ModelConfig, p, h, rot, taus=None, *, causal,
           attn_impl="blockwise_full", enc_kv=None):
    """One pre-norm block; ``p`` is one layer's slice (cast here)."""
    p = _cast(p, h.dtype)
    a_tau = taus.get("attn") if taus else None
    f_tau = taus.get("ffn") if taus else None
    h = _residual(h)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    x = act_clip(x, a_tau)
    h = _residual(h + attention_block(p["attn"], x, cfg, rot, causal=causal,
                                      attn_impl=attn_impl))
    if enc_kv is not None:
        x = rmsnorm(h, p["ln_cross"], cfg.norm_eps)
        h = _residual(h + attention_block(p["cross"], x, cfg, rot,
                                          causal=False, kv_override=enc_kv))
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    y, aux = ffn_block(p["ffn"], x, cfg, f_tau)
    return _residual(h + y), aux


def _residual(h):
    """The residual stream in the block entry's layout (the reference's
    constraint there), kept after each sublayer's sum as GSPMD carries that
    constraint back to the sums; otherwise DTensor may leave a sum sharded
    over the sequence, whose gradient later products cannot flatten."""
    return shard(h, "batch", None, "embed")


def _run_blocks(cfg: ModelConfig, h, stacked, L, rot, sparsity=None, *,
                causal=True, attn_impl="blockwise_full", remat=None):
    """The L stacked blocks in turn; ``remat`` (None | "full" | "dots")
    checkpoints each block for the backward pass, as the JAX package's
    ``jax.checkpoint`` of its scanned block does."""
    block = remat_fn(functools.partial(_block, cfg), remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, p in enumerate(unstack_layers(stacked)[:L]):
        h, a = block(p, h, rot, _layer_taus(sparsity, i), causal=causal,
                     attn_impl=attn_impl)
        aux = aux + a
    return h, aux


def encode(cfg: ModelConfig, params, frames, *, remat=None):
    """Whisper encoder: frames (B, F, d) precomputed by the stub frontend."""
    dt = dtype_of(cfg.dtype)
    h = frames.to(dt) + params["enc_pos"][None].to(dt)
    positions = torch.arange(frames.shape[1], device=frames.device)
    h, _ = _run_blocks(cfg, h, params["enc_blocks"], cfg.enc_layers,
                       rope(cfg, positions), causal=False, remat=remat)
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _dec_pos(params, positions, dt):
    return params["dec_pos"][torch.clamp(positions, 0, 4095)].to(dt)


def lm_forward(cfg: ModelConfig, params, tokens, *, frames=None,
               sparsity=None, attn_impl="blockwise_full", q_offset=0,
               remat=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hidden, logits, aux_loss). tokens: (B, S) integer.
    ``sparsity``: optional per-layer clip thresholds, ``{"attn": (L,),
    "ffn": (L,)}``. ``attn_impl``: ``blockwise_attention``'s ``impl``.
    ``remat``: None | "full" | "dots" (the backward pass's checkpointing of
    each block; the forward value does not change)."""
    dt = dtype_of(cfg.dtype)
    h = _embed(params, tokens, dt)
    h = shard(h, "batch", None, "embed")
    positions = q_offset + torch.arange(tokens.shape[1], device=tokens.device)
    rot = rope(cfg, positions)

    if not cfg.is_encoder_decoder:
        h, aux = _run_blocks(cfg, h, params["blocks"], cfg.num_layers,
                             rot, sparsity, attn_impl=attn_impl, remat=remat)
    else:
        assert frames is not None, "whisper needs frame embeddings"
        enc = encode(cfg, params, frames, remat=remat)
        h = h + _dec_pos(params, positions, dt)
        B, F_ = enc.shape[:2]
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim

        def layer(p, h, taus):
            # the cross K/V come from the layer's stored (float32) weights,
            # so they are float32 whatever the compute dtype
            xk = shard_ctx.reshape(_mm(enc, p["cross"]["wk"]), B, F_, KV, hd)
            xv = shard_ctx.reshape(_mm(enc, p["cross"]["wv"]), B, F_, KV, hd)
            return _block(cfg, p, h, rot, taus, causal=True,
                          attn_impl=attn_impl, enc_kv=(xk, xv))

        # the JAX package checkpoints the whole decoder layer, cross K/V
        # included, for any remat
        layer = remat_fn(layer, "full" if remat else None)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, p in enumerate(unstack_layers(params["blocks"])):
            h, a = layer(p, h, _layer_taus(sparsity, i))
            aux = aux + a
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, h)
    return h, logits, aux


def unembed(cfg: ModelConfig, params, h):
    w = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return shard(h @ w.to(h.dtype), "batch", None, "vocab")


# ===================================================================== #
# Loss (+ MTP)
# ===================================================================== #
def lm_loss(cfg: ModelConfig, params, batch, *, sparsity=None,
            attn_impl="blockwise_full", remat=None):
    """Full-sequence forward; loss on S-1 shifts (+0.1 x the MTP loss).
    ``remat`` checkpoints the blocks (encoder and MTP block too)."""
    tokens = batch["tokens"]
    frames = batch.get("frames")
    h, logits, aux = lm_forward(cfg, params, tokens, frames=frames,
                                sparsity=sparsity, attn_impl=attn_impl,
                                remat=remat)
    loss = softmax_xent(logits[:, :-1], tokens[:, 1:]).mean()
    metrics = {"xent": loss, "aux": aux}

    if cfg.mtp_depth:                            # predict token t+2 from h_t
        dt = h.dtype
        # roll(tokens, -1) as two slices, which DTensor shards too (torch
        # 2.11 has no sharding rule for roll)
        nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        nxt_emb = _embed(params, nxt, dt)
        z = torch.cat([rmsnorm(h, params["mtp"]["norm"], cfg.norm_eps),
                       nxt_emb], dim=-1) @ params["mtp"]["proj"].to(dt)
        positions = torch.arange(z.shape[1], device=z.device)
        z, _ = _run_blocks(cfg, z, params["mtp"]["block"], cfg.mtp_depth,
                           rope(cfg, positions), attn_impl=attn_impl,
                           remat=remat)
        z = rmsnorm(z, params["final_norm"], cfg.norm_eps)
        mtp_logits = unembed(cfg, params, z[:, :-2])
        mtp_loss = softmax_xent(mtp_logits, tokens[:, 2:]).mean()
        metrics["mtp"] = mtp_loss
        loss = loss + 0.1 * mtp_loss
    return loss + aux, metrics


# ===================================================================== #
# Serving: prefill + single-token decode with KV caches
# ===================================================================== #
def _cache_len(cfg: ModelConfig, S_max: int) -> int:
    """Slots per sequence: a ring of ``window`` slots under sliding-window
    attention, else S_max."""
    return min(S_max, cfg.attn_window) if cfg.attn_window else S_max


def init_cache(cfg: ModelConfig, B: int, S_max: int, device="cuda") -> Params:
    dt = dtype_of(cfg.dtype)
    L = cfg.num_layers
    eff = _cache_len(cfg, S_max)

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        cache = {"ckv": z(L, B, eff, m.kv_lora_rank),
                 "krope": z(L, B, eff, m.qk_rope_head_dim)}
    else:
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache = {"k": z(L, B, eff, KV, hd), "v": z(L, B, eff, KV, hd)}
    cache["pos"] = z(B, dtype=torch.int64)        # true next position (rope)
    if cfg.is_encoder_decoder:
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache["xk"] = z(L, B, cfg.num_frames, KV, hd)
        cache["xv"] = z(L, B, cfg.num_frames, KV, hd)
    return cache


def _cache_write(buf, new, at):
    """buf (B,S,...), new (B,1,...): write row ``at[b] < S`` of sequence b
    in place (the B rows only). A sharded cache (a ``DTensor``, whose
    row write DTensor cannot keep in place) is rewritten whole through a
    one-hot select, the reference's baseline write."""
    if shard_ctx.is_sharded(buf):
        B, S = buf.shape[:2]
        hit = torch.arange(S, device=buf.device)[None, :] == at[:, None]
        hit = hit.reshape((B, S) + (1,) * (buf.ndim - 2))
        buf.copy_(torch.where(hit, new.to(buf.dtype), buf))
        return
    buf[torch.arange(buf.shape[0], device=buf.device), at] = \
        new[:, 0].to(buf.dtype)


def decode_step(cfg: ModelConfig, params, cache, token):
    """token: (B, 1) integer. Returns (logits (B,1,V), cache): the cache's
    buffers are updated in place and ``pos`` advances by one."""
    dt = dtype_of(cfg.dtype)
    B = token.shape[0]
    h = _embed(params, token, dt)                             # (B,1,d)
    pos = cache["pos"]
    rot = rope(cfg, pos[:, None])

    if cfg.is_encoder_decoder:
        h = h + _dec_pos(params, pos, dt)[:, None]

    for i in range(cfg.num_layers):
        p = _cast(take_layer(params["blocks"], i), dt)
        x = rmsnorm(h, p["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            o = _mla_decode_attn(p["attn"], x, cfg, cache["ckv"][i],
                                 cache["krope"][i], pos, rot)
        else:
            o = _gqa_decode_attn(p["attn"], x, cfg, cache["k"][i],
                                 cache["v"][i], pos, rot)
        h = h + o
        if cfg.is_encoder_decoder:
            x = rmsnorm(h, p["ln_cross"], cfg.norm_eps)
            q = shard_ctx.reshape(x @ p["cross"]["wq"], B, 1, cfg.num_heads,
                                  cfg.resolved_head_dim)
            xo = decode_attention(q, cache["xk"][i], cache["xv"][i],
                                  torch.full((B,), cfg.num_frames,
                                             device=h.device))
            h = h + shard_ctx.reshape(xo, B, 1, -1) @ p["cross"]["wo"]
        x = rmsnorm(h, p["ln2"], cfg.norm_eps)
        y, _ = ffn_block(p["ffn"], x, cfg)
        h = h + y
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, h)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache


def _gqa_decode_attn(p, x, cfg, k_buf, v_buf, pos, rot):
    """One token of GQA attention against a layer's cache (B,S,KV,hd),
    written in place at slot ``pos % S`` (a ring when S is the window)."""
    B = x.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    q, k, v = _gqa_qkv(p, x, cfg, rot)
    S = k_buf.shape[1]
    slot = pos % S
    _cache_write(k_buf, k, slot)
    _cache_write(v_buf, v, slot)
    eff_len = torch.clamp(pos + 1, max=S)
    o = decode_attention(q, k_buf, v_buf, eff_len)
    return shard_ctx.reshape(o, B, 1, H * hd) @ p["wo"]


def _mla_decode_attn(p, x, cfg, ckv_buf, krope_buf, pos, rot):
    """Absorbed-form MLA decode: cache latent ckv + shared k_rope. The
    cache has no ring: a token at or past its end is not written (as the
    JAX package's one-hot write drops it) and attends to the rows there."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    f32 = torch.float32
    qa = rmsnorm(x @ p["wq_a"], p["q_norm_a"], cfg.norm_eps)
    q = shard_ctx.reshape(qa @ p["wq_b"], B, 1, H,
                          m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = rotate(q_rope, *rot)

    kv_a = x @ p["wkv_a"]
    ckv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rmsnorm(ckv, p["kv_norm_a"], cfg.norm_eps)
    k_rope = rotate(k_rope[:, :, None, :], *rot)[:, :, 0]

    S = ckv_buf.shape[1]
    inside = (pos < S)[:, None, None]
    at = torch.clamp(pos, max=S - 1)
    rows = torch.arange(B, device=x.device)
    _cache_write(ckv_buf, torch.where(inside, ckv, ckv_buf[rows, at][:, None]),
                 at)                                          # (B,S,kvr)
    _cache_write(krope_buf, torch.where(inside, k_rope,
                                        krope_buf[rows, at][:, None]), at)

    wkv_b = shard_ctx.reshape(p["wkv_b"], m.kv_lora_rank, H,
                              m.qk_nope_head_dim + m.v_head_dim)
    wk_b, wv_b = wkv_b[..., :m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]
    # absorb: q_eff = q_nope @ wk_b^T  -> latent space
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].to(f32), wk_b.to(f32))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bhr,bsr->bhs", q_eff, ckv_buf.to(f32)) +
         torch.einsum("bhn,bsn->bhs", q_rope[:, 0].to(f32),
                      krope_buf.to(f32))) * scale
    valid = torch.arange(S, device=x.device)[None, :] < (pos + 1)[:, None]
    s = s.masked_fill(~valid[:, None, :], -1e30)
    pr = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", pr, ckv_buf.to(f32))
    o = torch.einsum("bhr,rhv->bhv", lat, wv_b.to(f32))       # (B,H,v)
    o = shard_ctx.reshape(o, B, 1, H * m.v_head_dim).to(x.dtype)
    return o @ p["wo"]


def _to_cache(a, eff: int):
    """Keep the last ``eff`` positions of a (B, S, ...); right-pad short
    prompts with zeros."""
    if a.shape[1] >= eff:
        return a[:, -eff:]
    pad = [0, 0] * (a.ndim - 2) + [0, eff - a.shape[1]]
    return F.pad(a, pad)


def prefill(cfg: ModelConfig, params, tokens, S_max: int, *, frames=None,
            attn_impl="blockwise_full", sparsity=None, prompt_lens=None):
    """Run the full prompt, build the cache. Returns (last_logits, cache).

    ``prompt_lens`` (B,) serves a ragged batch padded on the right to the
    chunk max: logits are gathered at each row's last real token
    (``lens[b] - 1``; causal attention never looks right, so the pad
    columns cannot leak in) and ``cache["pos"]`` starts at ``lens`` — the
    decode steps overwrite the pad rows' cache slots and mask past
    ``pos``, exactly the "pad to max then mask" batching discipline."""
    B, S = tokens.shape
    dt = dtype_of(cfg.dtype)
    dev = tokens.device
    cache = init_cache(cfg, B, S_max, device=dev)
    if shard_ctx.is_sharded(tokens):     # a sharded prompt fills a sharded cache
        mesh = tokens.device_mesh
        cache = distribute(cache, mesh, cache_spec(mesh, cache))
    h = _embed(params, tokens, dt)
    positions = torch.arange(S, device=dev)
    rot = rope(cfg, positions)

    enc = None
    if cfg.is_encoder_decoder:
        enc = encode(cfg, params, frames)
        h = h + _dec_pos(params, positions, dt)

    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    eff = _cache_len(cfg, S_max)
    assert S <= eff or S % eff == 0, (
        "ring-buffer slot arithmetic needs prompt len < cache or a multiple "
        f"of the window; got S={S}, eff={eff}")

    for i in range(cfg.num_layers):
        p = _cast(take_layer(params["blocks"], i), dt)
        taus = _layer_taus(sparsity, i)
        a_tau = taus.get("attn") if taus else None
        f_tau = taus.get("ffn") if taus else None
        h = _residual(h)
        x = rmsnorm(h, p["ln1"], cfg.norm_eps)
        x = act_clip(x, a_tau)
        if cfg.mla is not None:
            q, k, v, ckv, k_rope = _mla_qkv(p["attn"], x, cfg, rot)
            o = blockwise_attention(q, k, v, causal=True, impl=attn_impl)
            cache["ckv"][i] = _to_cache(ckv, eff)
            cache["krope"][i] = _to_cache(k_rope[:, :, 0], eff)
        else:
            q, k, v = _gqa_qkv(p["attn"], x, cfg, rot)
            o = blockwise_attention(q, k, v, causal=True,
                                    window=cfg.attn_window, impl=attn_impl)
            cache["k"][i] = _to_cache(k, eff)
            cache["v"][i] = _to_cache(v, eff)
        h = _residual(h + shard_ctx.reshape(o, B, S, -1) @ p["attn"]["wo"])
        if cfg.is_encoder_decoder:
            x = rmsnorm(h, p["ln_cross"], cfg.norm_eps)
            xk = shard_ctx.reshape(enc @ p["cross"]["wk"], B, enc.shape[1], KV, hd)
            xv = shard_ctx.reshape(enc @ p["cross"]["wv"], B, enc.shape[1], KV, hd)
            h = _residual(h + attention_block(p["cross"], x, cfg, rot,
                                              causal=False,
                                              kv_override=(xk, xv)))
            cache["xk"][i] = xk
            cache["xv"][i] = xv
        x = rmsnorm(h, p["ln2"], cfg.norm_eps)
        y, _ = ffn_block(p["ffn"], x, cfg, f_tau)
        h = _residual(h + y)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if prompt_lens is None:
        cache["pos"].fill_(S)
        return unembed(cfg, params, h[:, -1:]), cache
    assert S <= eff, (
        "ragged prefill (prompt_lens) needs the whole padded prompt "
        f"resident in the cache window; got S={S}, eff={eff}")
    lens = torch.as_tensor(prompt_lens, dtype=torch.int64, device=dev)
    cache["pos"] = lens
    last = torch.gather(h, 1, (lens - 1)[:, None, None].expand(B, 1, h.shape[-1]))
    return unembed(cfg, params, last), cache
