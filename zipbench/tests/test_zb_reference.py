"""The plain references against the port's resident model, on the CPU at a
tiny size, both in float32 on the benchmark's own weights: the port's
decode steps one token at a time (as the served path computes) against the
reference's full causal pass."""
import dataclasses
import subprocess
import sys

import pytest
import torch

from zipbench import modelcfg, weights
from zipbench.reference import common, compare, mla_moe
from zipbench.tests.tiny import REPO, TINY_DSV2


def setup(conf, seed=4):
    cfg = dataclasses.replace(modelcfg.model_config(conf), dtype="float32")
    hp = type("HP", (), dict(dataclasses.asdict(cfg),
                             rope_scaling=conf.get("rope_scaling")))
    p = weights.make_weights(cfg, seed, "cpu", 1.15)
    return cfg, hp, p


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_mla_moe_matches_the_ports_decode():
    from repro_torch.models import decode_step, init_cache
    cfg, hp, p = setup(TINY_DSV2)
    toks = torch.randint(0, cfg.vocab_size, (1, 12),
                         generator=torch.Generator().manual_seed(0))
    cache = init_cache(cfg, 1, 12, device="cpu")
    port = torch.cat([decode_step(p, cfg, toks[:, i:i + 1], cache, i)[0]
                      for i in range(12)], dim=1)
    with common.no_tf32():
        ref = mla_moe.logits(p, hp, toks)
    assert rel(port, ref) < 1e-5


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import zipbench.reference.mla_moe, zipbench.reference.compare\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib')]\n"
            "assert not bad, bad\n" % str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_gap_reads_the_served_tokens():
    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 2.5]])
    assert compare.gaps(ref, torch.tensor([1, 2])).tolist() == [0.0, 0.5]


@pytest.mark.parametrize("seed", [4, 5])
def test_control_separates_from_float32(seed):
    """The float8 control moves the logits far more than float32 round-off
    does: its relative error stays above 1e-3 where float32 gives 1e-5."""
    cfg, hp, p = setup(TINY_DSV2, seed)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 8), generator=g)
    a, b = (mla_moe.logits(p, hp, toks, prec) for prec in ("f32", "fp8"))
    assert rel(b, a) > 1e-3


def test_yarn_at_factor_1_is_plain_rope_and_at_40_the_published_one():
    """The configuration's ``rope_scaling`` at factor 1 (as run) leaves
    RoPE and the softmax scale as they are, bit for bit; at the published
    factor 40 (64 rope dims, 4,096 original positions) the pairs up to 10
    keep their frequency, those from 23 on are divided by 40, and the
    softmax scale grows by (0.1 * 0.707 * ln 40 + 1) ** 2."""
    import math
    rs = dict(TINY_DSV2["rope_scaling"])
    x = torch.randn(1, 9, 2, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9)
    assert torch.equal(common.rotate(x, pos, 10000.0, rs),
                       common.rotate(x, pos, 10000.0))
    assert common.softmax_factor(rs) == 1.0
    rs["factor"] = 40
    plain = common.rope_inv_freq(64, 10000.0, None, "cpu")
    yarn = common.rope_inv_freq(64, 10000.0, rs, "cpu")
    assert torch.equal(yarn[:11], plain[:11])
    torch.testing.assert_close(yarn[23:], plain[23:] / 40)
    assert (yarn[11:23] < plain[11:23]).all()
    assert common.softmax_factor(rs) == pytest.approx(
        (0.1 * 0.707 * math.log(40) + 1) ** 2)
