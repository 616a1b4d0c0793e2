"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of the reference package's registry: its 11 architectures, every
family, plus the port's own (``PORT_ARCHS``). Arch ids use the dashed
names (e.g. ``tinyllama-1.1b``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    AUDIO, DENSE, FAMILIES, HYBRID, MOE, SSM, VLM, AfmoeConfig,
    AfmoeMoEConfig, EncoderConfig, HybridConfig, MoEConfig, ModelConfig,
    MoSKAConfig, SSMConfig,
)

_ARCH_MODULES: Dict[str, str] = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-8b": "llama3_8b",
    "mistral-large-123b": "mistral_large_123b",
    "internvl2-76b": "internvl2_76b",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    # the paper's own model (not part of the assigned 10)
    "moska-llama3.1-8b": "moska_llama31_8b",
}

ASSIGNED_ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "moska-llama3.1-8b"]

#: the port's own configurations, which the reference package has not:
#: ``get_config`` takes them, ``list_archs`` keeps to the reference's
PORT_ARCHS: Dict[str, str] = {
    "trinity-mini": "trinity_mini",
}


def get_config(arch: str) -> ModelConfig:
    mods = {**_ARCH_MODULES, **PORT_ARCHS}
    if arch not in mods:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(mods)}")
    mod = importlib.import_module(f"repro_torch.configs.{mods[arch]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)
