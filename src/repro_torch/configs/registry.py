"""Registry of the 10 assigned architectures (one module per arch)."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    mamba2_2_7b,
    whisper_tiny,
    llama4_scout_17b_a16e,
    llama4_maverick_400b_a17b,
    internvl2_2b,
    gemma3_27b,
    glm4_9b,
    command_r_plus_104b,
    llama3_8b,
    jamba_1_5_large_398b,
)

_MODULES = [
    mamba2_2_7b,
    whisper_tiny,
    llama4_scout_17b_a16e,
    llama4_maverick_400b_a17b,
    internvl2_2b,
    gemma3_27b,
    glm4_9b,
    command_r_plus_104b,
    llama3_8b,
    jamba_1_5_large_398b,
]

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
