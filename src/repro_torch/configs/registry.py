"""Architecture registry: --arch <id> resolution for launchers and tests."""

from __future__ import annotations

from repro_torch.configs import (
    internlm2_1_8b,
    qwen1_5_110b,
    command_r_35b,
    glm4_9b,
    whisper_base,
    grok_1_314b,
    qwen2_moe_a2_7b,
    zamba2_1_2b,
    xlstm_350m,
    internvl2_76b,
)

_MODULES = {
    "internlm2-1.8b": internlm2_1_8b,
    "qwen1.5-110b": qwen1_5_110b,
    "command-r-35b": command_r_35b,
    "glm4-9b": glm4_9b,
    "whisper-base": whisper_base,
    "grok-1-314b": grok_1_314b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "zamba2-1.2b": zamba2_1_2b,
    "xlstm-350m": xlstm_350m,
    "internvl2-76b": internvl2_76b,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
SMOKES = {name: mod.SMOKE for name, mod in _MODULES.items()}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str):
    return SMOKES[name]


def list_archs():
    return sorted(ARCHS)
