"""Unified model API: ``build_model(cfg)`` returns family-appropriate fns.

All families expose the same surface:
    init(gen, device="cuda") -> params (float32, drawn from a torch.Generator)
    loss(params, batch, **kw) -> (scalar, metrics)       [forward value]
    prefill(params, tokens, S_max, **kw) -> (logits, cache/state)
    decode_step(params, cache, token) -> (logits, cache)
    init_cache(B, S_max, device="cuda") -> cache (zeros)

Every entry point runs on the card unless the caller passes
``device="cpu"``; the serving loop resolves the device and raises when there
is no card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    # top-level parameters the family reads in float32 whatever the compute
    # dtype (its module's READ_IN_FLOAT32); every other float32 leaf is cast
    # to the compute dtype wherever it is read
    read_in_float32: Tuple[str, ...] = ()


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "cnn":
        from repro_torch.models import cnn
        return ModelAPI(
            cfg=cfg,
            init=functools.partial(cnn.init_params, cfg),
            loss=functools.partial(cnn.loss, cfg))
    if cfg.rwkv is not None:
        from repro_torch.models import rwkv

        def rwkv_state(B, S_max, device="cuda"):
            return rwkv.init_state(cfg, B, device=device)
        return ModelAPI(
            cfg=cfg,
            init=functools.partial(rwkv.init_params, cfg),
            loss=functools.partial(rwkv.loss, cfg),
            prefill=functools.partial(rwkv.prefill, cfg),
            decode_step=functools.partial(rwkv.decode_step, cfg),
            init_cache=rwkv_state,
            read_in_float32=rwkv.READ_IN_FLOAT32)
    if cfg.ssm is not None:
        from repro_torch.models import ssm
        return ModelAPI(
            cfg=cfg,
            init=functools.partial(ssm.init_params, cfg),
            loss=functools.partial(ssm.loss, cfg),
            prefill=functools.partial(ssm.prefill, cfg),
            decode_step=functools.partial(ssm.decode_step, cfg),
            init_cache=functools.partial(ssm.init_state, cfg),
            read_in_float32=ssm.READ_IN_FLOAT32)
    from repro_torch.models import transformer as tfm
    return ModelAPI(
        cfg=cfg,
        init=functools.partial(tfm.init_params, cfg),
        loss=functools.partial(tfm.lm_loss, cfg),
        prefill=functools.partial(tfm.prefill, cfg),
        decode_step=functools.partial(tfm.decode_step, cfg),
        init_cache=functools.partial(tfm.init_cache, cfg),
        read_in_float32=tfm.READ_IN_FLOAT32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of a cell (shapes and
    dtypes, nothing allocated): the reference's ``ShapeDtypeStruct``s, with
    its int32 as the port's int64 and bfloat16 as bfloat16.

    train  -> {'batch': {'tokens': (B, S)}} (+frames for audio; images and
              labels for cnn)
    prefill-> {'batch': {'tokens': (B, S)}} (+frames)
    decode -> {'token': (B, 1), 'cache': <tree>}    (cache of size S)
    """
    B, S = shape.global_batch, shape.seq_len

    def sds(sh, dt=torch.int64):
        return torch.empty(sh, dtype=dt, device="meta")

    if cfg.family == "cnn":
        return {"batch": {"images": sds((B, cfg.img_res, cfg.img_res, 3),
                                        torch.bfloat16),
                          "labels": sds((B,))}}

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((B, S))}
        if cfg.is_encoder_decoder:
            batch["frames"] = sds((B, cfg.num_frames, cfg.d_model),
                                  torch.bfloat16)
        return {"batch": batch}

    # decode: one new token against a populated cache of logical length S
    cache = build_model(cfg).init_cache(B, S, device="meta")
    return {"token": sds((B, 1)), "cache": cache}


def serving_params(api: ModelAPI, params, device):
    """``params`` on ``device`` with every float32 leaf that prefill and
    decode cast to the compute dtype at each read cast once, here. A cast is
    exact and deterministic, so the outputs are bit-identical to those on
    the float32 tree; the serving loop then reads the weights in the compute
    dtype (at Qwen3-0.6B's width, 1.19 GB of bfloat16 a step instead of
    2.38 GB of float32 plus the cast)."""
    from repro_torch.models.common import dtype_of
    dt = dtype_of(api.cfg.dtype)

    def go(p, cast):
        if isinstance(p, dict):
            return {k: go(v, cast) for k, v in p.items()}
        p = p.to(device)
        return p.to(dt) if cast and p.dtype == torch.float32 else p

    return {k: go(v, k not in api.read_in_float32) for k, v in params.items()}
