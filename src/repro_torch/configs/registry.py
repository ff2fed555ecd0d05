"""Architecture registry: ``--arch <id>`` resolution.

Trimmed to the architectures the port serves so far: the GQA MoE family
(qwen2-moe-a2.7b, with the paper's qwen1.5-moe-a2.7b name for it) and the
MLA MoE family (deepseekv2-lite, deepseek-v2-236b).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, reduced

# arch-id -> module name
_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    # paper evaluation models
    "deepseekv2-lite": "deepseekv2_lite",
    "qwen1.5-moe-a2.7b": "qwen2_moe_a27b",   # identical architecture
}

PAPER_MODELS: List[str] = ["deepseekv2-lite", "qwen1.5-moe-a2.7b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg = mod.CONFIG
    if cfg.name != arch and arch in PAPER_MODELS:
        cfg = dataclasses.replace(cfg, name=arch)
    return cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
