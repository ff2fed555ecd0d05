"""A configuration file of ``zipbench/configs/`` -> the port's ``ModelConfig``.

The file holds the published config's own keys (Hugging Face names) with the
values as run; ``reduced`` in BENCHMARK.json lists the keys changed from the
source.  The module of the file's ``model_type``
(``zipbench/families/<model_type>.py``) maps those keys onto the port's
config fields and refuses a value the port cannot run (so a file never
claims a mechanism the run leaves out).
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path


def load(path) -> dict:
    return json.loads(Path(path).read_text())


def family(c: dict):
    """The module of configuration file contents `c`'s ``model_type``."""
    mt = c["model_type"]
    mod = f"zipbench.families.{mt}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"{c['name']}: model_type {mt!r} has no family: "
                         f"add zipbench/families/{mt}.py (see "
                         f"zipbench/families/__init__.py)") from None


def model_config(c: dict):
    """The port's ModelConfig for configuration file contents `c`."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=c["name"], **family(c).fields(c))


def alpha(c: dict) -> float:
    """The router-skew exponent the file assumes (0: no skew)."""
    return float(c.get("assumed", {}).get("router_skew_alpha", 0.0))


def zlib_level(c: dict) -> int:
    return int(c.get("assumed", {}).get("zlib_level", 1))
