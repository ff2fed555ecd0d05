"""Architecture registry: ``--arch <id>`` resolution.

Trimmed to the architectures the port serves so far (the MoE main path).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

# arch-id -> module name
_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
