"""--arch registry: name -> ModelConfig."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs import (deepseek_v2_lite_16b, deepseek_v3_671b,
                                 jamba_v0_1_52b, llama3_8b, mamba2_370m,
                                 phi4_mini_3_8b, pixtral_12b, qwen2_5_3b,
                                 qwen3_1_7b, whisper_medium)

ARCHITECTURES: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_5_3b, llama3_8b, mamba2_370m, phi4_mini_3_8b,
              jamba_v0_1_52b, deepseek_v2_lite_16b, pixtral_12b,
              deepseek_v3_671b, qwen3_1_7b, whisper_medium)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """Documented skips (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        # full-attention enc-dec out of family; dense archs use the
        # sliding-window variant (enabled by the launcher), SSM/hybrid native.
        if cfg.family == "audio":
            return False
    return True
