"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of the reference package's registry: its 11 architectures, every
family. Arch ids use the dashed names (e.g. ``tinyllama-1.1b``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    AUDIO, DENSE, FAMILIES, HYBRID, MOE, SSM, VLM, EncoderConfig,
    HybridConfig, MoEConfig, ModelConfig, MoSKAConfig, SSMConfig,
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


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)
