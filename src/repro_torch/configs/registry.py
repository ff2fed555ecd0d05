"""Architecture registry: ``--arch <id>`` resolution.

Every architecture the JAX package registers: the dense GQA family
(granite-8b, deepseek-coder-33b, starcoder2-3b, qwen3-14b), the GQA MoE
family (qwen2-moe-a2.7b, with the paper's qwen1.5-moe-a2.7b name for it),
the MLA MoE family (deepseekv2-lite, deepseek-v2-236b), the SSM family
(mamba2-370m), the hybrid family (jamba-v0.1-52b), the encoder-decoders
with learned positions (switch-large-128, the paper's third evaluation
model, and whisper-small) and M-RoPE over input embeddings (qwen2-vl-2b).
``ASSIGNED`` names the ten the dry run's cells cover, each against every
entry of ``SHAPES`` (``all_cells``; ``shape_applicable`` marks the skips).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Tuple

from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, ModelConfig,
                                     reduced)

# arch-id -> module name
_ARCH_MODULES = {
    "granite-8b": "granite_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-14b": "qwen3_14b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-370m": "mamba2_370m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "whisper-small": "whisper_small",
    "qwen2-vl-2b": "qwen2_vl_2b",
    # paper evaluation models
    "deepseekv2-lite": "deepseekv2_lite",
    "qwen1.5-moe-a2.7b": "qwen2_moe_a27b",   # identical architecture
    "switch-large-128": "switch_large_128",
}

ASSIGNED: List[str] = [
    "granite-8b", "deepseek-coder-33b", "starcoder2-3b", "qwen3-14b",
    "qwen2-moe-a2.7b", "deepseek-v2-236b", "mamba2-370m", "jamba-v0.1-52b",
    "whisper-small", "qwen2-vl-2b",
]

PAPER_MODELS: List[str] = ["deepseekv2-lite", "qwen1.5-moe-a2.7b",
                           "switch-large-128"]


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


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  Returns (ok, reason-if-skip)."""
    SHAPE_BY_NAME[shape_name]                 # KeyError on an unknown shape
    if shape_name == "long_500k":
        if cfg.family not in ("ssm", "hybrid"):
            return False, ("pure full-attention arch: 512k dense KV decode "
                           "skipped per assignment (sub-quadratic archs "
                           "only); see DESIGN.md")
    return True, ""


def all_cells(archs=None) -> List[Tuple[str, str]]:
    """All (arch, shape) cells, including ones marked skip."""
    archs = archs or ASSIGNED
    return [(a, s.name) for a in archs for s in SHAPES]
