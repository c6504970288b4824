"""Architecture registry: one module per assigned architecture."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, LONG_CONTEXT_ARCHS, ModelConfig,
                                ShapeSpec, shape_applicable)

from repro_torch.configs import (gemma2_27b, llama4_maverick_400b_a17b,
                           llava_next_mistral_7b, mamba2_130m,
                           phi4_mini_3_8b, qwen2_0_5b, qwen3_moe_235b_a22b,
                           recurrentgemma_2b, seamless_m4t_medium,
                           starcoder2_3b)

_MODULES = {
    "seamless-m4t-medium": seamless_m4t_medium,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "mamba2-130m": mamba2_130m,
    "gemma2-27b": gemma2_27b,
    "starcoder2-3b": starcoder2_3b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "qwen2-0.5b": qwen2_0_5b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke_config()


def all_cells():
    """All (arch, shape) dry-run cells incl. applicability flag."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            out.append((name, shape.name, shape_applicable(cfg, shape)))
    return out
