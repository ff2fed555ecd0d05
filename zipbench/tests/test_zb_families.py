"""What belongs to one model family sits in files of its own: a
configuration of a new ``model_type`` joins with new files and new
BENCHMARK.json entries alone, and moving the one family there is into its
module changed nothing that the resident cell reads."""
import hashlib
import json
import shutil
from dataclasses import asdict

import pytest
import torch

from zipbench import modelcfg, weights
from zipbench.tests.tiny import CELLS, REPO, TINY_DSV2, run_cell

# sha256 of every leaf of make_weights(TINY_DSV2, seed, "cpu", 1.15) (path,
# dtype, shape and bytes, in leaf order), computed on the tree before the
# families moved out of modelcfg.py and the driver
WEIGHT_DIGESTS = {
    2**31 + 77:
        "04d4595cdac9efcb24aebc6b26ad6d08d34fb380f9edce5b3dd8b81818bbcb81",
    5: "ddeccd1716cff7f7a2a311cea0a68af0e05f8b352ed66fa3dbe5faa980402456",
}
# sha256 of the resident cell's Run.hp (every attribute but ``published``)
# as sorted JSON, computed on the same tree
HP_DIGEST = "d9f1380b7fb7cd0988db487bdb83afeb6f41bc073f8046e6094bed9e4865e11e"


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in weights.leaves(tree):
        t = t.detach().contiguous().cpu()
        h.update(repr((path, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(WEIGHT_DIGESTS))
def test_weights_are_the_parents_bit_for_bit(seed):
    cfg = modelcfg.model_config(TINY_DSV2)
    assert digest(weights.make_weights(cfg, seed, "cpu", 1.15)) == \
        WEIGHT_DIGESTS[seed]


def test_resident_cells_hp_is_the_parents():
    from zipbench.harness import Run
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    run = Run(REPO, bench, "dsv2lite-b16-resident", 1, 1.0, False,
              torch.device("cpu"), 0.0)
    hp = dict(vars(run.hp))
    published = hp.pop("published")
    assert hashlib.sha256(json.dumps(hp, sort_keys=True).encode()
                          ).hexdigest() == HP_DIGEST
    assert hp == dict(asdict(run.cfg), rope_scaling=published["rope_scaling"])
    assert published == modelcfg.load(
        REPO / "zipbench/configs/deepseekv2_lite.json")
    from zipbench.reference import mla_moe
    assert run.family.REFERENCE is mla_moe


def test_unknown_model_type_names_the_file_to_add():
    c = dict(TINY_DSV2, model_type="unheard_of")
    with pytest.raises(ValueError, match="zipbench/families/unheard_of.py"):
        modelcfg.model_config(c)


EXTRA = "e_score_correction_bias"


def with_extra_leaf(monkeypatch):
    """Patch the port's structure to carry one more 1-D leaf, [E] f32, in
    each MoE layer's FFN."""
    plain = weights.structure

    def structure(cfg):
        tree = plain(cfg)
        for lp in tree["layers"]:
            if "router" in lp["ffn"]:
                lp["ffn"][EXTRA] = torch.empty(cfg.n_experts,
                                               dtype=torch.float32,
                                               device="meta")
        return tree
    monkeypatch.setattr(weights, "structure", structure)


def correction_bias(path, t, gen):
    if path[-1] != EXTRA:
        return None
    return 0.01 * torch.randn(t.shape, generator=gen, dtype=t.dtype,
                              device=gen.device)


def test_leaf_rule_fills_the_leaf_the_common_rules_lack(monkeypatch):
    cfg = modelcfg.model_config(TINY_DSV2)
    seed = 2**31 + 9
    base = dict(weights.leaves(weights.make_weights(cfg, seed, "cpu", 1.15)))
    with_extra_leaf(monkeypatch)
    with pytest.raises(NotImplementedError, match=EXTRA):
        weights.make_weights(cfg, seed, "cpu", 1.15)
    tree = weights.make_weights(cfg, seed, "cpu", 1.15,
                                leaf_rule=correction_bias)
    got = dict(weights.leaves(tree))
    extra = sorted(p for p in got if p[-1] == EXTRA)
    assert len(extra) == 2 and set(got) == set(base) | set(extra)
    for p, t in base.items():
        assert torch.equal(got[p], t), p
    gen = torch.Generator("cpu")
    gen.manual_seed(seed ^ 0xFA11)
    for p in extra:
        assert torch.equal(got[p], 0.01 * torch.randn(cfg.n_experts,
                                                      generator=gen)), p


def test_leaf_rule_without_a_rule_or_of_another_shape_is_refused(
        monkeypatch):
    cfg = modelcfg.model_config(TINY_DSV2)
    with_extra_leaf(monkeypatch)
    with pytest.raises(NotImplementedError, match=EXTRA):
        weights.make_weights(cfg, 1, "cpu", 1.15,
                             leaf_rule=lambda path, t, gen: None)
    with pytest.raises(ValueError, match=EXTRA):
        weights.make_weights(cfg, 1, "cpu", 1.15,
                             leaf_rule=lambda path, t, gen: torch.zeros(3))


ALIAS_FAMILY = '''
from zipbench.families.deepseek_v2 import fields
from zipbench.reference import tiny_alias_ref as REFERENCE
'''

ALIAS_REFERENCE = '''
import json
from pathlib import Path

from zipbench.reference import mla_moe

SEEN = Path(__file__).resolve().parents[2] / "published_seen.json"


def logits(params, hp, tokens, prec="f32"):
    SEEN.write_text(json.dumps(hp.published))
    return mla_moe.logits(params, hp, tokens, prec)
'''


def test_a_new_family_arrives_as_new_files_alone(tiny_root, tmp_path):
    """A family module, its reference, a configuration of its
    ``model_type``, a cell file, a reader that reuses an existing one and
    BENCHMARK.json entries: the traced cell runs correct on the CPU,
    through the new reference, which sees the file's own keys, and reports
    the new metric alone."""
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    zb = root / "zipbench"
    before = {p: p.read_bytes() for p in zb.rglob("*.py")}
    before.update((p, p.read_bytes()) for p in zb.rglob("*.json"))
    conf = dict(TINY_DSV2, name="alias-tiny", model_type="tiny_alias",
                tiny_marker=7)
    (zb / "families/tiny_alias.py").write_text(ALIAS_FAMILY)
    (zb / "reference/tiny_alias_ref.py").write_text(ALIAS_REFERENCE)
    (zb / "configs/alias-tiny.json").write_text(json.dumps(conf))
    (zb / "workloads/tiny-alias-resident.json").write_text(
        json.dumps(CELLS["tiny-dsv2-resident"][2]))
    (zb / "metrics/server_self_ms_alias.py").write_text(
        "from zipbench.metrics.server_self_ms import read  # noqa: F401\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "alias-tiny", "source": "test",
                             "file": "zipbench/configs/alias-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-alias-resident",
                               "config": "alias-tiny",
                               "traffic": "tiny.closed2", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "server_self_ms_alias", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "out_tok_s",
                               "workloads": ["tiny-alias-resident"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, last, err = run_cell(root, "tiny-alias-resident", seed=2**31 + 21,
                             trace=1)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and last["failed"] == 0, last
    assert set(last["metrics"]) == {"server_self_ms_alias"}
    assert last["metrics"]["server_self_ms_alias"]["value"] > 0
    seen = json.loads((root / "published_seen.json").read_text())
    assert seen == conf
    assert all(p.read_bytes() == b for p, b in before.items())
