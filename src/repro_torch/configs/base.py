"""Config dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``; input shapes as
``ShapeConfig``. Configs are plain frozen dataclasses so they hash, compare and
serialize trivially (the checkpoint manager stores them as JSON).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0          # DeepSeek-style always-on experts
    expert_d_ff: int = 0                 # per-expert hidden dim (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk: int = 64                      # chunked-scan length for training


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64                 # rank of the data-dependent decay MLP
    mix_lora: int = 32                   # rank of the token-shift mix MLP


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "dense"                # dense | moe | ssm | hybrid | audio | vlm | cnn
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 256
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: int = 0                 # 0 = full attention; >0 = sliding window (SWA)
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # state-space / rwkv
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): one *shared* attention block applied every k ssm layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    num_frames: int = 0                  # encoder sequence length (precomputed frames)
    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0
    # misc
    tied_embeddings: bool = True
    norm_eps: float = 1e-5
    act: str = "silu"                    # silu | gelu | relu2 (rwkv)
    dtype: str = "bfloat16"
    # CNN-only (paper's own benchmark models)
    cnn_arch: str = ""                   # resnet18 | resnet50 | mobilenetv2 | mobilenetv3s | mobilenetv3l | convnext_t
    img_res: int = 224
    num_classes: int = 1000

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is feasible: O(1)/O(W) per-token state."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_window > 0      # SWA bounds the KV cache

    @property
    def has_decode(self) -> bool:
        return self.family != "cnn"      # all assigned archs autoregress (whisper: decoder side)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


# The four assigned LM shape cells.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason when skipped."""
    if cfg.family == "cnn":
        return (shape.kind == "train", "CNNs: train-style shapes only")
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (False, "full quadratic attention: 500k KV cache/attn infeasible; "
                       "skipped per DESIGN.md (sub-quadratic archs only)")
    return (True, "")


# ---------------------------------------------------------------------- #
# Reduced ("smoke") configs: same family/topology, tiny dims. Used by the
# per-arch smoke tests and CPU examples; the full configs are exercised only
# through the dry-run (ShapeDtypeStruct, no allocation).
# ---------------------------------------------------------------------- #
def reduce_config(cfg: ModelConfig) -> ModelConfig:
    def _shrink(v, lo, hi):
        return max(lo, min(v, hi))

    kw = {}
    kw["num_layers"] = _shrink(cfg.num_layers, 2, 3 if cfg.hybrid_attn_every else 2)
    kw["d_model"] = 64
    kw["num_heads"] = 4
    kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads < cfg.num_heads else 4
    kw["head_dim"] = 16
    kw["d_ff"] = 128
    kw["vocab_size"] = 503              # prime-ish: catches padding bugs
    kw["num_frames"] = 12 if cfg.num_frames else 0
    kw["enc_layers"] = 2 if cfg.enc_layers else 0
    kw["attn_window"] = 8 if cfg.attn_window else 0
    kw["mtp_depth"] = cfg.mtp_depth
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2, expert_d_ff=32)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=8, head_dim=8, expand=2, conv_dim=4, chunk=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, mix_lora=4)
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
        kw["num_layers"] = 5
    if cfg.family == "cnn":
        kw = {"img_res": 32, "num_classes": 11}
    return dataclasses.replace(cfg, **kw)


SMOKE_SHAPES = {
    "train": ShapeConfig("smoke_train", 32, 4, "train"),
    "prefill": ShapeConfig("smoke_prefill", 32, 2, "prefill"),
    "decode": ShapeConfig("smoke_decode", 48, 2, "decode"),
}
