"""Architecture registry: --arch <id> -> ModelConfig (all ten archs of the zoo)."""
from __future__ import annotations

from repro_torch.configs import (dbrx_132b, gemma3_4b, gemma3_12b, granite_3_8b,
                                 llama32_vision_90b, mamba2_780m, mixtral_8x7b,
                                 qwen3_8b, recurrentgemma_9b, seamless_m4t_medium)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma3-4b": gemma3_4b,
    "mamba2-780m": mamba2_780m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen3-8b": qwen3_8b,
    "granite-3-8b": granite_3_8b,
    "gemma3-12b": gemma3_12b,
    "mixtral-8x7b": mixtral_8x7b,
    "dbrx-132b": dbrx_132b,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()
