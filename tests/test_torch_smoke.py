"""``chip_smoke.py``'s phases rehearsed on the CPU at smoke size (smoke
configs in place of the published ones, the ``torch.cuda`` calls stubbed,
no CLI subprocess), for what they report rather than for what the card
measures."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    sys.path.insert(0, str(REPO))
    import chip_smoke
    sys.path.remove(str(REPO))
    import repro_torch.configs as configs
    from repro_torch.configs import registry
    from repro_torch.configs.base import reduced

    def small(arch):
        # mamba2-370m has no FFN as published; its smoke config would add
        # one
        return reduced(registry.get_config(arch),
                       **({"d_ff": 0} if arch == chip_smoke.MAMBA_ARCH
                          else {}))

    monkeypatch.setattr(configs, "get_config", small)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "run_cli", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "MAMBA_PREFILL", 64)
    (REPO / "build").mkdir(exist_ok=True)
    return chip_smoke


def test_ssm_phase_keeps_jamba_store_numbers(smoke, monkeypatch, tmp_path):
    """Phase 6's numbers: ``build_store_s`` and ``store_ratio`` are
    jamba's store's, mamba2's store's sit under ``mamba2``."""
    import repro_torch.core.store as store_mod
    built = {}
    orig = store_mod.build_store

    def recording(params, cfg, *a, **k):
        store = orig(params, cfg, *a, **k)
        built[cfg.name] = store.ratio()
        return store

    monkeypatch.setattr(store_mod, "build_store", recording)
    _, numbers = smoke.ssm_phase(torch, np, torch.device("cpu"),
                                 str(tmp_path))
    jamba = next(v for k, v in built.items() if k.startswith("jamba"))
    mamba = next(v for k, v in built.items() if k.startswith("mamba2"))
    assert jamba != mamba
    assert numbers["store_ratio"] == jamba
    assert numbers["mamba2"]["store_ratio"] == mamba
    assert numbers["mamba2"]["build_store_s"] > 0
    assert {"zipserver", "mamba2-resident"} <= set(numbers["mamba2"])
