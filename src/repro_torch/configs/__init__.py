"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig, RWKVConfig,
                                ShapeConfig, SSMConfig, SHAPES, SHAPE_BY_NAME,
                                SMOKE_SHAPES, cell_supported, reduce_config)

from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3_671b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_0_6b
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm_12b
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen2_5_3b
from repro_torch.configs.deepseek_67b import CONFIG as _deepseek_67b
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon_34b
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6_1_6b
from repro_torch.configs.whisper_base import CONFIG as _whisper_base
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2_1_2b
from repro_torch.configs.paper_cnns import PAPER_CNNS

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _deepseek_v3_671b, _mixtral_8x7b, _qwen3_0_6b, _stablelm_12b,
        _qwen2_5_3b, _deepseek_67b, _chameleon_34b, _rwkv6_1_6b,
        _whisper_base, _zamba2_1_2b,
    )
}
REGISTRY: Dict[str, ModelConfig] = dict(ASSIGNED)
REGISTRY.update({c.name: c for c in PAPER_CNNS})


def _canon(name: str) -> str:
    """Registry keys use hyphens/dots ("deepseek-v3-671b", "qwen3-0.6b");
    CLI flags and module names use underscores ("deepseek_v3_671b").
    Canonicalize to bare alphanumerics so both spellings resolve."""
    return "".join(ch for ch in name.lower() if ch.isalnum())


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    by_canon = {_canon(k): v for k, v in REGISTRY.items()}
    if _canon(name) in by_canon:
        return by_canon[_canon(name)]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")


def list_archs(assigned_only: bool = False) -> List[str]:
    return sorted(ASSIGNED if assigned_only else REGISTRY)


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
    "ShapeConfig", "SHAPES", "SHAPE_BY_NAME", "SMOKE_SHAPES",
    "cell_supported", "reduce_config", "get_config", "list_archs",
    "ASSIGNED", "REGISTRY", "PAPER_CNNS",
]
