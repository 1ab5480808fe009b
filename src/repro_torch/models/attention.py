"""Attention implementations (plain PyTorch, as the JAX package's are plain
JAX: no kernel of the reference exists for attention).

``blockwise_attention`` is a flash-style, memory-bounded attention: a loop
over KV blocks with an online softmax, so peak memory is O(S·d + S·block_k)
instead of O(S^2). ``impl="banded"`` visits only the KV blocks that intersect
the causal/window band (a static list of blocks, the same static-schedule
idea the paper uses for weight tiles). Scores and softmax are float32; masked
scores are ``NEG_INF = -1e30``, not ``-inf``, so a fully-masked row stays
finite. The masking (window, ``q_offset``, per-row ``kv_len``) is written out
as the JAX package writes it, so that the two packages compute the same
function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.ctx import shard

NEG_INF = -1e30


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(Q, K) float32 additive bias from causal/window structure."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


def _len_bias(k_pos, kv_len) -> torch.Tensor:
    """(B, K) float32 bias masking positions at or past each row's kv_len."""
    valid = k_pos[None, :] < kv_len[:, None]
    return torch.zeros(valid.shape, dtype=torch.float32,
                       device=valid.device).masked_fill_(~valid, NEG_INF)


def reference_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                        kv_len: Optional[torch.Tensor] = None):
    """Naive O(S^2)-memory oracle. q:(B,Sq,H,D) k,v:(B,Sk,KV,D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    qq = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qq.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(D))
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(k.shape[1], device=dev)
    bias = _mask_bias(q_pos, k_pos, causal, window)
    if kv_len is not None:                       # per-sequence valid length
        bias = bias[None] + _len_bias(k_pos, kv_len)[:, None]   # (B, Sq, Sk)
        s = s + bias[:, None, None]
    else:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def _band_blocks(nkb: int, block_k: int, q_offset: int, Sq: int,
                 causal: bool, window: int):
    """KV-block indices that intersect the band for ANY query."""
    blocks = []
    q_lo, q_hi = q_offset, q_offset + Sq - 1
    for j in range(nkb):
        k_lo, k_hi = j * block_k, (j + 1) * block_k - 1
        if causal and k_lo > q_hi:
            continue
        if window > 0 and k_hi < q_lo - window + 1:
            continue
        blocks.append(j)
    return blocks


def blockwise_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                        block_k=512, kv_len: Optional[torch.Tensor] = None,
                        impl="blockwise_full"):
    """Flash-style attention. q:(B,Sq,H,D) k,v:(B,Sk,KV,D) -> (B,Sq,H,D).

    impl:
      blockwise_full  visit every KV block, masking (baseline)
      banded          visit only KV blocks that intersect the causal/window band
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    dev = q.device
    if Sk <= block_k * 2:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    if Sk % block_k:                                  # pad ragged KV, mask tail
        pad = block_k - Sk % block_k
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), Sk, dtype=torch.int64, device=dev)
        Sk = Sk + pad
    G = H // KV
    nkb = Sk // block_k
    qq = q.reshape(B, Sq, KV, G, D).to(torch.float32) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    blocks = _band_blocks(nkb, block_k, q_offset, Sq, causal, window) \
        if impl == "banded" else range(nkb)

    # the online-softmax carry and each score block stay batch-sharded under
    # a sharding context (the reference's constraints on its scan carry)
    def _c(x):
        return shard(x, "batch", "kv_heads", *([None] * (x.ndim - 2)))

    m = _c(torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev))
    l = _c(torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev))
    acc = _c(torch.zeros((B, KV, G, Sq, Dv), dtype=torch.float32, device=dev))
    for j in blocks:
        kj = k[:, j * block_k:(j + 1) * block_k]
        vj = v[:, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bqkgd,bskd->bkgqs", qq, kj.to(torch.float32))
        s = shard(s, "batch", "kv_heads", None, None, None)
        k_pos = j * block_k + torch.arange(block_k, device=dev)
        bias = _mask_bias(q_pos, k_pos, causal, window)                 # (Sq, bk)
        if kv_len is not None:
            bias = bias[None, None, None] + \
                _len_bias(k_pos, kv_len)[:, None, None, None, :]
        s = s + bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = _c(l * corr + p.sum(dim=-1))
        acc = _c(acc * corr[..., None] +
                 torch.einsum("bkgqs,bskd->bkgqd", p, vj.to(torch.float32)))
        m = _c(m_new)
    o = acc / torch.clamp(l, min=1e-30)[..., None]            # (B,KV,G,Sq,Dv)
    o = o.movedim(3, 1).reshape(B, Sq, H, Dv)
    return o.to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=0):
    """Single-token decode. q:(B,1,H,D); caches:(B,Smax,KV,D); kv_len:(B,).

    Attends to positions < kv_len (per sequence); with a window only the last
    ``window`` positions are valid. O(Smax) per step.
    """
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    dev = q.device
    qq = q.reshape(B, KV, G, D).to(torch.float32) / math.sqrt(D)
    s = torch.einsum("bkgd,bskd->bkgs", qq, k_cache.to(torch.float32))
    pos = torch.arange(k_cache.shape[1], device=dev)
    valid = pos[None, :] < kv_len[:, None]
    if window > 0:
        valid &= pos[None, :] >= (kv_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)
