"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of the reference package's registry, limited to the dense archs
the port serves. Arch ids use the dashed names (e.g. ``tinyllama-1.1b``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (public re-exports)
    DENSE, FAMILIES, MoEConfig, ModelConfig, MoSKAConfig,
)

_ARCH_MODULES: Dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-8b": "llama3_8b",
    # the paper's own model
    "moska-llama3.1-8b": "moska_llama31_8b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)
