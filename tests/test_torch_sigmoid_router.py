"""DeepSeek-V3's sigmoid router (``noaux_tc`` at one group) in the port,
and kanana-2-30b-a3b, the configuration that runs it:

* ``route``'s sigmoid path against its formula written out in float64,
  with a correction bias that changes the chosen set; its softmax path bit
  for bit as it was before the router had a second kind;
* the port's resident ``decode_step`` (one token at a time) and
  ``BatchServer`` over ``ZipServer.decode_rows(device_cache, ragged)``
  against the benchmark's plain reference (``zipbench/reference/
  mla_moe_sigmoid.py``, a full causal pass), in float32 at a tiny size;
* the bias leaf: resident in ``ZipServer``, out of the store, replicated
  by the sharding rules, drawn by the family's ``leaf_rule``;
* the family's mapping of the configuration file and its refusals, the
  registry entry at the published widths.
"""
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.store import ExpertStore, build_store
from repro_torch.distributed.sharding import Spec, param_pspecs
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import forward
from repro_torch.models.moe import route
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer
from zipbench import modelcfg, weights
from zipbench.families import deepseek_v3
from zipbench.reference import mla_moe_sigmoid

REPO = Path(__file__).resolve().parents[1]
KANANA = "kanana-2-30b-a3b"
KANANA_FILE = REPO / "zipbench/configs/kanana2_30b_a3b.json"

TINY = {
    "name": "kanana-tiny", "model_type": "deepseek_v3",
    "attention_bias": False, "first_k_dense_replace": 1, "head_dim": 8,
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "kv_lora_rank": 32, "moe_intermediate_size": 64, "moe_layer_freq": 1,
    "n_group": 1, "n_routed_experts": 16, "n_shared_experts": 1,
    "norm_topk_prob": True, "num_attention_heads": 4,
    "num_experts_per_tok": 6, "num_hidden_layers": 3,
    "num_key_value_heads": 4, "q_lora_rank": None, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "rms_norm_eps": 1e-06, "rope_interleave": True,
    "rope_scaling": None, "rope_theta": 1000000,
    "routed_scaling_factor": 2.448, "scoring_func": "sigmoid",
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 24, "vocab_size": 512,
    "assumed": {"zlib_level": 1, "router_skew_alpha": 1.15,
                "router_bias_std": 0.01}}

# float32 round-off between the port's step-by-step decode and the
# reference's full pass over the same float32 weights (the two add in
# other orders); rounding any product to bf16 moves the logits ~1e-3
REL = 1e-5


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------
def _sigmoid_cfg(**kw):
    return dataclasses.replace(get_smoke_config(KANANA), **kw)


def _formula(x, w, bias, k, norm, scale):
    """noaux_tc at one group, in float64 numpy: (sorted chosen ids [N, k],
    their gates [N, k] in that order)."""
    s = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ w.astype(np.float64))))
    ids = np.sort(np.argsort(-(s + bias), axis=-1, kind="stable")[:, :k], -1)
    g = np.take_along_axis(s, ids, -1)
    if norm:
        g = g / g.sum(-1, keepdims=True)
    return ids, g * scale


def _sorted(top_p, top_i):
    o = torch.argsort(top_i, dim=-1)
    return (torch.gather(top_i, -1, o).numpy(),
            torch.gather(top_p, -1, o).double().numpy())


@pytest.mark.parametrize("norm", [True, False])
def test_sigmoid_route_matches_the_formula(norm):
    cfg = _sigmoid_cfg(n_experts=16, top_k=6, router_norm_topk=norm)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, cfg.d_model, generator=g)
    w = 0.05 * torch.randn(cfg.d_model, 16, generator=g)
    bias = 0.05 * torch.randn(16, generator=g)
    top_p, top_i, probs = route(w, x, cfg, bias)
    ids, gates = _sorted(top_p, top_i)
    want_ids, want_g = _formula(x.numpy(), w.numpy(), bias.numpy(), 6, norm,
                                2.448)
    assert top_p.dtype == torch.float32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(gates, want_g, rtol=1e-6)
    torch.testing.assert_close(probs, torch.sigmoid(x @ w))
    if norm:      # renormalised, the gates sum to the routed scale
        np.testing.assert_allclose(top_p.sum(-1).numpy(), 2.448, rtol=1e-6)
    with pytest.raises(ValueError, match="correction bias"):
        route(w, x, cfg)


def test_bias_changes_the_choice_and_never_a_gate():
    """Expert 5 has the lowest score of the six logits, but a bias of 0.6
    puts it in the top 2; the gates are the unbiased scores."""
    cfg = _sigmoid_cfg(n_experts=6, top_k=2, router_norm_topk=True,
                       routed_scale=2.448)
    d = cfg.d_model
    logit = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5])
    x = torch.zeros(1, d)
    x[0, 0] = 1.0
    w = torch.zeros(d, 6)
    w[0] = logit
    zero = torch.zeros(6)
    bias = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.6])
    p, i, _ = route(w, x, cfg, bias)
    ids, gates = _sorted(p, i)
    assert route(w, x, cfg, zero)[1].sort().values.tolist() == [[0, 1]]
    assert ids.tolist() == [[0, 5]]
    s = torch.sigmoid(logit).double().numpy()
    want = np.array([s[0], s[5]]) / (s[0] + s[5]) * 2.448
    np.testing.assert_allclose(gates[0], want, rtol=1e-6)
    np.testing.assert_allclose(gates.sum(), 2.448, rtol=1e-6)


def _route_before(router_w, x, cfg):
    """``route`` as it was before the router had a second kind."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    return top_p, top_i, probs


@pytest.mark.parametrize("arch,norm", [("deepseekv2-lite", False),
                                       ("qwen2-moe-a2.7b", True),
                                       ("switch-large-128", False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softmax_route_is_bit_identical_to_before(arch, norm, dtype):
    cfg = get_smoke_config(arch)
    assert cfg.router_scoring == "softmax" and cfg.routed_scale == 1.0
    assert cfg.router_norm_topk == norm
    g = torch.Generator().manual_seed(11)
    x = torch.randn(3, 5, cfg.d_model, generator=g).to(dtype)
    w = 0.2 * torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    for a, b in zip(route(w, x, cfg), _route_before(w, x, cfg)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    p = init_params(cfg, seed=1, device="cpu")
    assert all("router_bias" not in lp.get("ffn", {})
               for lp in p["layers"])


def test_sigmoid_config_has_no_balance_loss():
    cfg = _sigmoid_cfg(dtype="float32")
    p = init_params(cfg, seed=2, device="cpu")
    moe_layers = [lp for lp in p["layers"] if "router" in lp.get("ffn", {})]
    assert moe_layers and all(
        torch.equal(lp["ffn"]["router_bias"], torch.zeros(cfg.n_experts))
        for lp in moe_layers)
    probs = torch.rand(4, cfg.n_experts)
    with pytest.raises(ValueError, match="softmax"):
        moe_lib.load_balance_loss(probs, torch.zeros(4, 2, dtype=torch.long),
                                  cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 6),
                         generator=torch.Generator().manual_seed(0))
    logits, _, aux = forward(p, cfg, toks)
    assert torch.isfinite(logits).all() and float(aux) == 0.0
    with pytest.raises(ValueError, match="sigmoid router"):
        dataclasses.replace(get_smoke_config("deepseekv2-lite"),
                            routed_scale=16.0)


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------
def _tiny(seed, dtype="float32"):
    """(config, reference hp, weights) of TINY, drawn as the benchmark
    draws them."""
    cfg = dataclasses.replace(modelcfg.model_config(TINY), dtype=dtype)
    hp = types.SimpleNamespace(**dataclasses.asdict(cfg),
                               rope_scaling=TINY["rope_scaling"],
                               published=dict(TINY))
    p = weights.make_weights(cfg, seed, "cpu", modelcfg.alpha(TINY),
                             leaf_rule=deepseek_v3.leaf_rule)
    return cfg, hp, p


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [4, 2**31 + 5])
def test_decode_step_matches_the_reference(seed):
    cfg, hp, p = _tiny(seed)
    assert p["layers"][1]["ffn"]["router_bias"].abs().max() > 0
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(seed % 97))
    cache = init_cache(cfg, 2, 12, device="cpu")
    port = torch.cat([decode_step(p, cfg, toks[:, i:i + 1], cache, i)[0]
                      for i in range(12)], dim=1)
    ref = mla_moe_sigmoid.logits(p, hp, toks)
    assert _rel(port, ref) < REL


def _bf16_experts(p):
    """Round the routed experts to bf16 values in place (kept float32), so
    the store's bf16 planes hold them exactly."""
    for lp in p["layers"]:
        for name in weights.EXPERT_NAMES:
            t = lp["ffn"].get(name)
            if t is not None and "router" in lp["ffn"]:
                t.copy_(t.bfloat16().float())


def test_zipserver_decode_rows_matches_the_reference(tmp_path):
    """Three requests, two at a time, through ``BatchServer`` over
    ``ZipServer(device_cache, ragged)`` with every expert warmed into the
    slab, as the benchmark cell serves them; each served token's logits
    against the reference's teacher-forced full pass."""
    cfg, hp, p = _tiny(2**31 + 17)
    _bf16_experts(p)
    build_store(p, cfg, str(tmp_path / "store"), device="cpu").close()
    served = {k: v for k, v in p.items() if k != "layers"}
    served["layers"] = [{k: (dict(v) if k == "ffn" else v)
                         for k, v in lp.items()} for lp in p["layers"]]
    weights.drop_routed(served)
    zs = ZipServer(served, cfg, str(tmp_path / "store"), device="cpu",
                   device_cache=True, ffn_impl="ragged", L=2,
                   pool_sizes={"F": cfg.n_experts, "C": 0, "S": 0, "E": 0})
    try:
        for layer in range(cfg.n_layers):
            if cfg.moe_layer(layer):
                zs.engine.fetch_experts(layer, list(range(cfg.n_experts)))
        srv = BatchServer(served, cfg, max_batch=2, max_concurrency=2,
                          max_len=24, zip_server=zs, page_size=4)
        rng = np.random.default_rng(5)
        for n in (5, 3, 7):
            srv.submit(rng.integers(0, cfg.vocab_size, n), 5,
                       record_logits=True)
        done = srv.run()
        route_s = [s["route_s"] for s in zs.stats]
    finally:
        zs.close()
    assert len(done) == 3 and route_s and all(t > 0 for t in route_s)
    for r in done:
        assert r.error is None and len(r.logits) == len(r.output) == 5
        toks = torch.tensor(list(r.prompt) + r.output[:-1])[None]
        k = len(r.prompt) - 1
        ref = mla_moe_sigmoid.logits(p, hp, toks)[0, k:k + 5]
        assert _rel(torch.from_numpy(np.stack(r.logits)), ref) < REL, r.rid


# ---------------------------------------------------------------------------
# the bias leaf: resident, out of the store, replicated, drawn
# ---------------------------------------------------------------------------
def test_bias_stays_resident_out_of_the_store_and_replicated(tmp_path):
    cfg, _, p = _tiny(9, dtype="bfloat16")
    d = str(tmp_path / "store")
    build_store(p, cfg, d, device="cpu").close()
    st = ExpertStore(d)
    try:
        names = {t.name for g in st.groups.values() for t in g.tensors}
        assert len(st.groups) == 1 + (cfg.n_layers - 1) * cfg.n_experts
    finally:
        st.close()
    assert names == set(weights.EXPERT_NAMES)
    zs = ZipServer(p, cfg, d, device="cpu", device_cache=True,
                   ffn_impl="ragged")
    try:
        for i in zs._moe_layers:
            ffn = zs.layers[i]["ffn"]
            assert "w_up" not in ffn
            assert ffn["router_bias"] is p["layers"][i]["ffn"]["router_bias"]
    finally:
        zs.close()
    specs = param_pspecs(p, cfg, model_size=4)
    for i in range(1, cfg.n_layers):
        assert specs["layers"][i]["ffn"]["router_bias"] == Spec()
        assert specs["layers"][i]["ffn"]["w_up"] != Spec()


def test_leaf_rule_moves_a_share_of_the_top6_picks():
    """At the published router [2048, 128] with the cell's skew (alpha
    1.15), the bias at sigma 0.01 moves 10-25% of the top-6 picks away
    from the unbiased choice."""
    g = torch.Generator().manual_seed(2**31 + 3)
    w = 0.02 * torch.randn(2048, 128, generator=g)
    weights.apply_skew_(w, 1.15, torch.randperm(128, generator=g))
    bias = deepseek_v3.leaf_rule(("layers", 1, "ffn", "router_bias"),
                                 torch.empty(128), g)
    assert deepseek_v3.leaf_rule(("layers", 1, "ffn", "scale"),
                                 torch.empty(128), g) is None
    assert abs(float(bias.std()) - 0.01) < 0.003
    s = torch.sigmoid(torch.randn(4096, 2048, generator=g) @ w)
    a, b = (torch.zeros(4096, 128).scatter_(1, torch.topk(v, 6).indices, 1.0)
            for v in (s, s + bias))
    moved = float((a - b).clamp(min=0).sum() / (4096 * 6))
    assert 0.10 < moved < 0.25, moved


# ---------------------------------------------------------------------------
# the family, the file, the registry
# ---------------------------------------------------------------------------
def test_family_maps_the_kanana_file_onto_the_registry_config():
    c = modelcfg.load(KANANA_FILE)
    assert modelcfg.family(c) is deepseek_v3
    assert deepseek_v3.REFERENCE is mla_moe_sigmoid
    cfg = modelcfg.model_config(c)
    assert (cfg.n_layers, cfg.n_heads, cfg.n_experts, cfg.d_expert,
            cfg.top_k, cfg.router_scoring, cfg.routed_scale,
            cfg.router_norm_topk, cfg.head_dim) == \
        (5, 32, 128, 768, 6, "sigmoid", 2.448, True, 192)
    whole = dataclasses.replace(cfg, n_layers=48, name=KANANA)
    assert whole == get_config(KANANA)
    assert c["assumed"]["router_bias_std"] == deepseek_v3.BIAS_STD


@pytest.mark.parametrize("key,value", [
    ("n_group", 8), ("topk_group", 4), ("scoring_func", "softmax"),
    ("topk_method", "group_limited_greedy"), ("num_nextn_predict_layers", 1),
    ("rope_scaling", {"type": "yarn", "factor": 40}), ("head_dim", 128),
    ("qk_head_dim", 128)])
def test_family_refuses_what_the_port_cannot_run(key, value):
    """DeepSeek-V3's published grouped routing (n_group 8, topk_group 4),
    its MTP layer, its YaRN, and the rest, each refused naming its key."""
    c = dict(modelcfg.load(KANANA_FILE), **{key: value})
    with pytest.raises(ValueError, match=key):
        deepseek_v3.fields(c)


def test_registry_entry_at_published_widths():
    from repro_torch.launch.dryrun import model_bytes
    cfg = get_config(KANANA)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.n_shared_experts, cfg.d_expert, cfg.d_ff, cfg.vocab_size,
            cfg.rope_theta) == (48, 2048, 32, 512, 128, 64, 128, 128, 2,
                                768, 6144, 128256, 1e6)
    # bf16 weights, f32 routers and biases: ~61.4 GB whole
    assert 61.3e9 < model_bytes(cfg) < 61.45e9


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import zipbench.reference.mla_moe_sigmoid\n"
            "import zipbench.families.deepseek_v3\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib')]\n"
            "assert not bad, bad\n" % str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_resident_cell_maps_as_before():
    """``dsv2lite-b16-resident``'s reference hyper-parameters, less the two
    router fields (softmax, scale 1), hash as they did before the router
    had a second kind (the digest ``zipbench/tests/test_zb_families.py``
    pins)."""
    import hashlib
    from zipbench.harness import Run
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    run = Run(REPO, bench, "dsv2lite-b16-resident", 1, 1.0, False,
              torch.device("cpu"), 0.0)
    hp = dict(vars(run.hp))
    hp.pop("published")
    assert (hp.pop("router_scoring"), hp.pop("routed_scale")) == \
        ("softmax", 1.0)
    assert hashlib.sha256(json.dumps(hp, sort_keys=True).encode()
                          ).hexdigest() == \
        "d9f1380b7fb7cd0988db487bdb83afeb6f41bc073f8046e6094bed9e4865e11e"


# ---------------------------------------------------------------------------
# the comparison that follows the program's router at near-ties
# ---------------------------------------------------------------------------
def test_reference_follows_a_near_tie_only():
    """A choice whose lowest biased score lies within `tol` of the k-th is
    taken (and counted as forced); one further off is not (counted far)."""
    biased = torch.tensor([[0.90, 0.80, 0.700, 0.699, 0.10],
                           [0.90, 0.80, 0.700, 0.600, 0.10]])
    chosen = torch.tensor([[0, 3], [0, 3]])
    own = mla_moe_sigmoid.choose(biased, 2)
    assert own.tolist() == [[0, 1], [0, 1]]
    ties = {}
    got = mla_moe_sigmoid.choose(biased, 2, chosen, tol=0.15, ties=ties)
    assert got.tolist() == [[0, 3], [0, 1]]
    assert ties["rows"] == 2 and ties["forced"] == 1 and ties["far"] == 1
    assert ties["margin_max"] == pytest.approx(0.101, abs=1e-6)
    same = mla_moe_sigmoid.choose(biased, 2, own, tol=0.0, ties=ties)
    assert torch.equal(same, own) and ties["far"] == 1


def _tiny_cell(tmp_path):
    """A benchmark root holding TINY under the new cell's settings (tiny
    warm-up and sample)."""
    from zipbench.tests.tiny import make_root
    root = make_root(tmp_path)
    zb = root / "zipbench"
    (zb / "configs/kanana-tiny.json").write_text(json.dumps(TINY))
    spec = json.loads((zb / "workloads/kanana2-b16-resident.json")
                      .read_text())
    spec.update(warmup_steps=4, profile={"start_s": 0.0, "seconds": 0.5})
    spec["server"]["L"] = 2
    spec["check"].update(sample_tokens=20, sample_requests=4)
    (zb / "workloads/tiny-kanana-resident.json").write_text(json.dumps(spec))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kanana-tiny", "source": "test",
                             "file": "zipbench/configs/kanana-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-kanana-resident",
                               "config": "kanana-tiny",
                               "traffic": "tiny.closed2", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny-kanana-resident")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


UNBIASED = """
import torch
import repro_torch.serving.zipserve as zipserve
_route = zipserve.route
zipserve.route = lambda w, x, c, b=None: _route(w, x, c, torch.zeros_like(b))
"""


@pytest.mark.parametrize("prelude,correct", [("", True), (UNBIASED, False)],
                         ids=["program", "unbiased-choice"])
def test_new_cell_runs_on_the_cpu(tmp_path, prelude, correct):
    """The new cell's driver end to end at a tiny size: correct with
    ``route_far`` 0 and the three new per-layer metrics read; a server that
    chooses by the unbiased scores is refused by ``route_far``."""
    from zipbench.tests.tiny import run_cell
    root = _tiny_cell(tmp_path)
    rc, last, err = run_cell(root, "tiny-kanana-resident", seed=2**31 + 41,
                             trace=1, prelude=prelude)
    assert rc == 0, err[-3000:]
    checks = last["checks"]
    assert last["correct"] is correct, checks
    assert (checks["route_far"]["value"] == 0) is correct
    if correct:
        assert checks["gap_max"]["value"] < 0.05
        assert last["metrics"]["route_ms"]["value"] > 0
        assert last["metrics"]["blocked_ms_kanana2"]["value"] >= 0
