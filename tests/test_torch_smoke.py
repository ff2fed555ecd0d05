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


def test_multirank_phase_rehearsed(smoke, monkeypatch):
    """Phase 9 on 4 gloo ranks on the CPU at smoke widths: seq-sharded
    decode within its limit of the default path, the layer-0 cache shards
    bit-equal, the pipeline bit-identical to the sequential pass, each
    ledger equal to its reckoning and no kernel launched."""
    monkeypatch.syspath_prepend(str(REPO))     # the ranks import it
    monkeypatch.setattr(smoke, "MR_SEQ", 64)
    numbers = smoke.multirank_phase(torch, np, torch.device("cpu"))
    for key in ("seqshard_gqa", "seqshard_mla"):
        part = numbers[key]
        assert part["logits_rel_max"] <= smoke.MR_REL
        assert all(n == 0 for name, n in
                   part["written_entries_differing"].items()
                   if name.startswith("0/"))
        assert part["ledger"]["collective_ops"]["all-reduce"] > 0
    assert numbers["pipeline"]["ledger"]["collective_ops"] == {
        "collective-permute": smoke.MR_PIPE_MICRO + smoke.MR_PIPE_STAGES - 1,
        "all-reduce": 1}
    assert len(numbers["rank_wall_s"]) == smoke.MR_RANKS
