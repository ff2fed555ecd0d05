"""The benchmark's seeded weights."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from zipbench import modelcfg, weights
from zipbench.tests.tiny import REPO, TINY_DSV2

FULL = {"deepseekv2-lite": "deepseekv2_lite.json"}


def tiny_cfg():
    return modelcfg.model_config(TINY_DSV2)


def test_structure_is_the_ports():
    cfg = tiny_cfg()
    from repro_torch.models import init_params
    port = init_params(cfg, seed=0, device="cpu")
    ours = weights.make_weights(cfg, 1, "cpu", 1.15)
    a = {p: (tuple(t.shape), t.dtype) for p, t in weights.leaves(port)}
    b = {p: (tuple(t.shape), t.dtype) for p, t in weights.leaves(ours)}
    assert a == b


def test_seeded_and_independent_of_the_ports_init(monkeypatch):
    cfg = tiny_cfg()
    a = weights.make_weights(cfg, 2**31 + 5, "cpu", 1.15)
    import repro_torch.models.layers as layers
    import repro_torch.models.model as model
    monkeypatch.setattr(layers, "normal", lambda gen, shape, std, dt, dev:
                        torch.full(shape, 3.0, dtype=dt, device=dev))
    monkeypatch.setattr(model, "init_params", None)
    b = weights.make_weights(cfg, 2**31 + 5, "cpu", 1.15)
    c = weights.make_weights(cfg, 2**31 + 6, "cpu", 1.15)
    for (p, x), (_, y), (_, z) in zip(weights.leaves(a), weights.leaves(b),
                                      weights.leaves(c)):
        assert torch.equal(x, y), p
        if x.dim() > 1:
            assert not torch.equal(x, z), p


def test_drop_routed_counts_the_store_bytes():
    cfg = tiny_cfg()
    p = weights.make_weights(cfg, 0, "cpu", 0.0)
    assert weights.drop_routed(p) == 2 * 8 * 3 * 128 * 64 * 2
    assert all(name not in lp["ffn"] for lp in p["layers"]
               for name in weights.EXPERT_NAMES if "router" in lp["ffn"])


@pytest.mark.parametrize("arch,k,E", [("deepseekv2-lite", 6, 64)])
def test_router_skew_at_full_width(arch, k, E, capsys):
    """The share of top-k picks that go to the most-chosen quarter of the
    experts, with N(0, 1) inputs through a full-width router: uniform at
    alpha 0, skewed at the configuration's alpha (recorded in PERF.md)."""
    c = modelcfg.load(REPO / "zipbench/configs" / FULL[arch])
    cfg = modelcfg.model_config(c)
    alpha = modelcfg.alpha(c)
    shares = {}
    for a in (0.0, alpha):
        g = torch.Generator("cpu")
        g.manual_seed(1)
        w = torch.randn(cfg.d_model, cfg.n_experts, generator=g) * 0.02
        weights.apply_skew_(w, a, torch.randperm(E, generator=g))
        shares[a] = weights.top_quarter_share(w, k, 20000)
    with capsys.disabled():
        print(f"\n{arch}: top-quarter share {shares}")
    assert abs(shares[0.0] - 0.25) < 0.05
    assert shares[alpha] > shares[0.0] + 0.1


def test_configs_are_the_registrys_at_the_cut_depth():
    for arch, f in FULL.items():
        cfg = modelcfg.model_config(modelcfg.load(REPO / "zipbench/configs"
                                                  / f))
        reg = get_config(arch)
        cut = dataclasses.replace(reg, n_layers=cfg.n_layers,
                                  n_enc_layers=cfg.n_enc_layers)
        assert cfg == cut, arch


def test_a_file_claiming_what_the_port_cannot_run_is_refused():
    bad = dict(TINY_DSV2, scoring_func="sigmoid")
    with pytest.raises(ValueError, match="scoring_func"):
        modelcfg.model_config(bad)


def test_yarn_the_port_does_not_run_is_refused():
    """The port rotates by plain RoPE: YaRN at factor 1 maps, the published
    factor 40 is refused."""
    modelcfg.model_config(TINY_DSV2)
    bad = dict(TINY_DSV2, rope_scaling=dict(TINY_DSV2["rope_scaling"],
                                            factor=40))
    with pytest.raises(ValueError, match="rope_scaling"):
        modelcfg.model_config(bad)
