"""Architecture registry: ``--arch <id>`` resolution for all entry points."""

from __future__ import annotations

from typing import Callable

from repro_torch.models.common import ModelConfig

from . import (arctic_480b, codeqwen1_5_7b, deepseek_v2_236b, gemma2_2b,
               jamba_v0_1_52b, musicgen_large, phi4_mini_3_8b, qwen2_0_5b,
               qwen2_vl_2b, xlstm_350m)

_MODULES = (
    phi4_mini_3_8b,
    qwen2_0_5b,
    codeqwen1_5_7b,
    gemma2_2b,
    arctic_480b,
    deepseek_v2_236b,
    xlstm_350m,
    musicgen_large,
    jamba_v0_1_52b,
    qwen2_vl_2b,
)

BUILDERS: dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.build for m in _MODULES
}
ARCH_IDS: tuple[str, ...] = tuple(BUILDERS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in BUILDERS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return BUILDERS[arch_id]()


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return get_config(arch_id).reduced(**overrides)
