"""The MLA MoE family (deepseekv2-lite, deepseek-v2-236b) in the port,
against the JAX package and against itself.

The smoke widths are overridden so that ``head_dim`` (32),
``qk_nope_dim + qk_rope_dim`` (24 + 8) and ``v_head_dim`` (40) all differ,
with a ``kv_lora_rank`` of 48: a port that scaled the scores by
``head_dim`` or reshaped the output by it would fail here.
deepseek-v2-236b's smoke config, at the same widths, covers the q-LoRA
branch (``wq_a`` -> ``q_norm`` -> ``wq_b``).  Inputs are drawn with numpy
from a seed and cross into the port through ``params_from_jax``.

* **Attention** (``mla_forward`` plain and chunked, ``mla_decode`` and
  ``mla_decode_rows`` with ``absorb`` on and off): outputs and the latent
  cache within ``MAX_REL`` of the largest reference magnitude (on the CPU
  they agree bit for bit; the bound is the cross-package one); the decode
  functions write the new latent in place and nothing else.
* **The model** (``prefill``, resident ``decode_step``, ``generate``, the
  resident ``BatchServer``): logits within ``MAX_REL`` at worst and
  ``MEAN_REL`` on average, router ids identical, greedy tokens by teacher
  forcing.  These cross-package logit checks run at depth 2 (one dense
  layer, one MoE layer), the depth of the GQA family's: at depth 3 the
  two packages' bf16 add orders alone (identical routing) part by more
  than ``MAX_REL`` on some seeds, for the GQA family as well.
* **The store**: byte-identical to the reference's for the MLA config,
  the dense first layer as group ``(0, 0)``.
* **ZipServer** ``decode_step`` and ``decode_rows`` (under ``BatchServer``)
  against the reference's, device cache on and off; within the port, at
  depth 3 (two MoE layers), bit for bit: ragged ≡ grouped ≡ fused
  batched ≡ fused loop, device cache on ≡ off under eviction with
  ``cross_layer_depth=1``, planned (``mem_budget``) ≡ ragged;
  ``plan_summary()`` equal to the reference's with the planning
  constants pinned in both.  The plain loop oracle adds in bf16, as the
  JAX package's does, and is held within MAX_REL.
* **KVPagePool** over the latent leaves; **the CLI** with
  ``--arch deepseekv2-lite`` in its three modes; **continuous ≡ solo**
  (the assertions of test_torch_batching, restated for the latent pages).
* **Entry points refuse** a config the port does not serve (M-RoPE on
  MLA heads, learned positions in a decoder-only model, a hybrid whose
  Mamba2 mixers have no state width, an encoder-decoder of Mamba2
  mixers, embeddings tied with no token embedding) with
  ``NotImplementedError`` before any work.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.planner as ref_planner
import repro.models.attention as ref_attn
import repro.models.moe as ref_moe
import repro_torch.core.planner as port_planner
from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.planner import PlanConsts as RefConsts
from repro.core.store import build_store as ref_build_store
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models.model import forward as ref_forward
from repro.serving.generate import generate as ref_generate
from repro.serving.server import BatchServer as RefBatchServer
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.planner import PlanConsts
from repro_torch.core.store import ExpertStore, build_store
from repro_torch.models import attention as attn_lib
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.moe import route
from repro_torch.serving.generate import generate
from repro_torch.serving.kv_cache import KVPagePool, cache_bytes, grow_cache
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer
from test_torch_batching import (_ORIG_FREE, MODES, Recorder, _prompts,
                                 _serve, assert_same_request,
                                 settle_predictions)
from test_torch_models import (MAX_REL, MEAN_REL, assert_greedy_agrees,
                               both_params, numpy_params, serve_greedy)
from test_torch_serving import _forced_port, _forced_ref

MLA = dict(qk_nope_dim=24, qk_rope_dim=8, v_head_dim=40, kv_lora_rank=48)
LITE, BIG = "deepseekv2-lite", "deepseek-v2-236b"
POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}
TINY = {"F": 1, "C": 1, "S": 1, "E": 1}
B, S, STEPS = 2, 12, 4


def _mla_params(arch=LITE, n_layers=2):
    return both_params(n_layers, arch=arch, **MLA)


@pytest.fixture(scope="module")
def lite():
    return _mla_params()


@pytest.fixture(scope="module")
def big():
    return _mla_params(BIG)


@pytest.fixture(scope="module")
def lite_store(tmp_path_factory):
    """Depth 2 (dense + MoE) with the reference's store."""
    jcfg, jparams, cfg, params = _mla_params()
    d = str(tmp_path_factory.mktemp("store_mla2"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


@pytest.fixture(scope="module")
def lite3_store(tmp_path_factory):
    """Depth 3 (dense + two MoE layers) with the reference's store."""
    jcfg, jparams, cfg, params = _mla_params(n_layers=3)
    d = str(tmp_path_factory.mktemp("store_mla3"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= MAX_REL * scale, (
        what, np.abs(got - want).max(), scale)


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)


def _attn_both(models):
    """Layer 0's attention parameters in both packages (layer 0 is the
    dense prefix layer, outside the scanned stack)."""
    jcfg, jparams, cfg, params = models
    return jparams["decoder"]["prefix"][0]["attn"], params["layers"][0]["attn"]


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    from repro.configs import get_config as ref_get_config
    for arch in (LITE, BIG, "qwen1.5-moe-a2.7b", "qwen2-moe-a2.7b"):
        # the router's kind and scale: the port's alone, at their defaults
        mine = dataclasses.asdict(get_config(arch))
        assert (mine.pop("router_scoring"), mine.pop("routed_scale")) == \
            ("softmax", 1.0), arch
        assert mine == dataclasses.asdict(ref_get_config(arch)), arch
    cfg = get_config(LITE)
    assert (cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank,
            cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.top_k, cfg.d_expert, cfg.n_shared_experts, cfg.first_dense,
            cfg.d_ff, cfg.vocab_size) == (2048, 16, 512, 0, 64, 128, 128, 64,
                                          6, 1408, 2, 1, 10944, 102400)


@pytest.mark.parametrize("arch", [LITE, BIG])
def test_init_params_and_cache_shapes(arch):
    """The port's own init draws the reference's tree, leaf for leaf in
    shape and dtype; the latent cache is [B, T, kv_lora] + [B, T, rope]."""
    jcfg, jparams, cfg, params = _mla_params(arch, n_layers=3)
    mine = init_params(cfg, seed=0, device="cpu")
    for a, b in zip(mine["layers"], params["layers"]):
        sa = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), a)
        sb = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), b)
        assert sa == sb
    assert mine["layers"][0]["attn"]["kv_norm"].dtype == torch.float32
    assert ("wq_a" in mine["layers"][0]["attn"]) == bool(cfg.q_lora_rank)
    assert "router" not in mine["layers"][0]["ffn"]            # dense
    assert mine["layers"][0]["ffn"]["w_up"].shape == (cfg.d_model, cfg.d_ff)
    caches = init_cache(cfg, 2, 5, device="cpu")
    ref_caches = ref_init_cache(jcfg, 2, 5)
    assert {k: tuple(v.shape) for k, v in caches[0]["kv"].items()} == \
        {"ckv": (2, 5, 48), "k_rope": (2, 5, 8)} == \
        {k: tuple(v.shape) for k, v in
         ref_caches["prefix"][0]["kv"].items()}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("arch", [LITE, BIG])
def test_mla_forward_matches_reference(request, monkeypatch, arch, chunked):
    """Causal full-sequence MLA with its latent cache; ``chunked`` lowers
    the threshold in both packages so a 1024-token query runs as two
    chunks of ``Q_CHUNK`` = 512 rows."""
    models = request.getfixturevalue("lite" if arch == LITE else "big")
    jcfg, _, cfg, _ = models
    jp, p = _attn_both(models)
    Bq, Sq = 2, 16
    if chunked:
        for mod in (ref_attn, attn_lib):
            monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 2 * mod.Q_CHUNK)
        Bq, Sq = 1, 2 * attn_lib.Q_CHUNK
    jx, x = _bf16(np.random.default_rng(1).standard_normal(
        (Bq, Sq, cfg.d_model)))
    pos = np.broadcast_to(np.arange(Sq), (Bq, Sq))
    want_y, want_c = ref_attn.mla_forward(jp, jx, jcfg,
                                          jnp.asarray(pos, jnp.int32),
                                          return_cache=True)
    y, c = attn_lib.mla_forward(p, x, cfg, torch.from_numpy(pos.copy()),
                                return_cache=True)
    assert y.shape == (Bq, Sq, cfg.d_model)
    _close(y, want_y, "y")
    assert c.keys() == {"ckv", "k_rope"}
    for name in c:
        _close(c[name], want_c[name], name)
    if chunked:        # the chunked loop computes what one pass computes
        monkeypatch.setattr(attn_lib, "CHUNK_THRESHOLD", 10 ** 9)
        whole = attn_lib.mla_forward(p, x, cfg, torch.from_numpy(pos.copy()))
        _close(y, whole, "chunked vs whole")


def _latent(cfg, rng, Bc, T):
    jc, c = _bf16(rng.standard_normal((Bc, T, cfg.kv_lora_rank)))
    jr, r = _bf16(rng.standard_normal((Bc, T, cfg.qk_rope_dim)))
    return {"ckv": jc, "k_rope": jr}, {"ckv": c, "k_rope": r}


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "plain"])
@pytest.mark.parametrize("arch", [LITE, BIG])
@pytest.mark.parametrize("rows", [False, True],
                         ids=["decode", "decode_rows"])
def test_mla_decode_matches_reference(request, arch, absorb, rows):
    """``mla_decode`` (one position) and ``mla_decode_rows`` (mixed
    positions, T padded past the longest row): y within MAX_REL, the new
    latent written in place at each row's position and nothing else of
    the cache changed; absorbed and plain forms agree with each other."""
    models = request.getfixturevalue("lite" if arch == LITE else "big")
    jcfg, _, cfg, _ = models
    jp, p = _attn_both(models)
    rng = np.random.default_rng(2)
    Bd, T = 4, 16
    positions = np.asarray([3, 9, 0, 5]) if rows else np.full(Bd, 7)
    jx, x = _bf16(rng.standard_normal((Bd, 1, cfg.d_model)))
    jcache, old = _latent(cfg, rng, Bd, T)
    cache = {k: v.clone() for k, v in old.items()}
    if rows:
        want_y, want_c = ref_attn.mla_decode_rows(
            jp, jx, jcfg, jcache, jnp.asarray(positions, jnp.int32),
            absorb=absorb)
        y, got = attn_lib.mla_decode_rows(p, x, cfg, cache,
                                          torch.from_numpy(positions),
                                          absorb=absorb)
    else:
        want_y, want_c = ref_attn.mla_decode(jp, jx, jcfg, jcache,
                                             jnp.int32(7), absorb=absorb)
        y, got = attn_lib.mla_decode(p, x, cfg, cache, 7, absorb=absorb)
    assert got is cache and y.shape == (Bd, 1, cfg.d_model)
    _close(y, want_y, "y")
    idx = np.arange(Bd)
    for name in ("ckv", "k_rope"):
        _close(cache[name][idx, positions],
               np.asarray(want_c[name])[idx, positions], name)
        keep = torch.ones(Bd, T, dtype=torch.bool)
        keep[idx, positions] = False
        assert torch.equal(cache[name][keep].view(torch.int16),
                           old[name][keep].view(torch.int16)), name
    other = {k: v.clone() for k, v in old.items()}
    if rows:
        y2, _ = attn_lib.mla_decode_rows(p, x, cfg, other,
                                         torch.from_numpy(positions),
                                         absorb=not absorb)
    else:
        y2, _ = attn_lib.mla_decode(p, x, cfg, other, 7, absorb=not absorb)
    _close(y2, y, "absorbed vs plain")


# ---------------------------------------------------------------------------
# the model: prefill, resident decode, generate, resident BatchServer
# ---------------------------------------------------------------------------
def _recording_route(monkeypatch):
    seen = []
    orig = ref_moe.route

    def recording(router_w, x, c):
        out = orig(router_w, x, c)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(ref_moe, "route", recording)
    return seen


@pytest.mark.parametrize("arch", [LITE, BIG])
def test_prefill_matches_reference(request, monkeypatch, arch):
    """Logits, router ids and the per-layer latent caches of a causal
    prefill; ``forward`` gives the same logits bit for bit."""
    models = request.getfixturevalue("lite" if arch == LITE else "big")
    jcfg, jparams, cfg, params = models
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    seen = _recording_route(monkeypatch)
    want_lg, want_cache, _ = ref_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill", unroll=True)
    ids = []
    lg, caches = prefill(params, cfg, torch.from_numpy(toks), router_ids=ids)
    assert len(ids) == len(seen) == cfg.n_layers - cfg.first_dense
    for got_i, want_i in zip(ids, seen):
        assert np.array_equal(got_i.numpy(), want_i)
    got, want = _np(lg), _np(want_lg)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= MAX_REL * scale
    assert np.abs(got - want).mean() <= MEAN_REL * scale
    want_layers = list(want_cache["prefix"]) + [
        jax.tree.map(lambda a: a[i], want_cache["stack"]["sub_0"])
        for i in range(cfg.n_layers - cfg.first_dense)]
    for c, w in zip(caches, want_layers):
        assert c["kv"]["ckv"].shape == (B, S, cfg.kv_lora_rank)
        assert c["kv"]["k_rope"].shape == (B, S, cfg.qk_rope_dim)
        for name in ("ckv", "k_rope"):
            _close(c["kv"][name], w["kv"][name], name)
    full, _, _ = forward(params, cfg, torch.from_numpy(toks))
    assert torch.equal(full.view(torch.int16), lg.view(torch.int16))


@pytest.mark.parametrize("arch", [LITE, BIG])
def test_decode_step_matches_reference(request, monkeypatch, arch):
    models = request.getfixturevalue("lite" if arch == LITE else "big")
    jcfg, jparams, cfg, params = models
    steps = 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1))
    seen = _recording_route(monkeypatch)
    jcache = ref_init_cache(jcfg, B, steps)
    tcache = init_cache(cfg, B, steps, device="cpu")
    for i in range(steps):
        jl, jcache = ref_decode_step(
            jparams, jcfg, {"tokens": jnp.asarray(toks[i], jnp.int32)},
            jcache, jnp.int32(i), unroll=True)
        ids = []
        tl, tcache = decode_step(params, cfg, torch.from_numpy(toks[i]),
                                 tcache, i, router_ids=ids)
        got, want = _np(tl), _np(jl)
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= MAX_REL * scale, i
        assert np.abs(got - want).mean() <= MEAN_REL * scale, i
        assert len(ids) == len(seen) == 1
        assert np.array_equal(ids[0].numpy(), seen[0]), i
        seen.clear()


def test_generate_and_resident_server_match_reference(lite):
    """``generate`` and the resident ``BatchServer`` run MLA ``prefill``
    and ``decode_step`` with no code of their own: greedy tokens agree
    with the reference's by teacher forcing, and the server emits
    ``generate``'s tokens."""
    jcfg, jparams, cfg, params = lite
    Bg, Sg, N = 2, 6, 5
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (Bg, Sg))
    want_all, _ = ref_generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new_tokens=N)
    got_all, _ = generate(params, cfg, prompt, max_new_tokens=N)
    got_tok = got_all[:, Sg:]
    want_lg = _forced_ref(jparams, jcfg, prompt, want_all[:, Sg:])
    got_lg = _forced_port(params, cfg, prompt, want_all[:, Sg:])
    assert_greedy_agrees(got_lg, got_lg[:, :, -1].argmax(-1).T, want_lg)
    own = _forced_port(params, cfg, prompt, got_tok)
    assert np.array_equal(own[:, :, -1].argmax(-1).T, got_tok)
    srv = BatchServer(params, cfg, max_batch=Bg)
    ref_srv = RefBatchServer(jparams, jcfg, max_batch=Bg)
    for p in prompt:
        srv.submit(p, N)
        ref_srv.submit(p, N)
    done = sorted(srv.run(), key=lambda r: r.rid)
    ref_done = sorted(ref_srv.run(), key=lambda r: r.rid)
    assert np.array_equal(np.asarray([r.output for r in done]), got_tok)
    ref_tok = np.asarray([r.output for r in ref_done])
    assert np.array_equal(ref_tok, want_all[:, Sg:])


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def test_store_bytes_match_reference(lite3_store, tmp_path):
    _, _, cfg, params, ref_dir = lite3_store
    build_store(params, cfg, str(tmp_path), k_shards=4, device="cpu",
                workers=2)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(tmp_path))
    _, mismatch, errors = filecmp.cmpfiles(ref_dir, str(tmp_path), names,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    st = ExpertStore(str(tmp_path))
    keys = sorted(st.groups)
    # the dense first layer is one always-active group (0, 0)
    assert keys[0] == (0, 0) and not any(l == 0 and e for l, e in keys)
    assert len(keys) == 1 + (cfg.n_layers - 1) * cfg.n_experts
    assert st.groups[(0, 0)].full_bytes == 3 * cfg.d_model * cfg.d_ff * 2
    st.close()


# ---------------------------------------------------------------------------
# ZipServer against the reference
# ---------------------------------------------------------------------------
def _decode(zs, cfg, steps=STEPS):
    """Greedy decode through either package's ZipServer."""
    return serve_greedy(zs, cfg.vocab_size, steps, B=B, S=S)


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["device", "host"])
def test_zipserver_decode_step_matches_reference(lite_store, device_cache):
    jcfg, jparams, cfg, params, d = lite_store
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True,
              device_cache=device_cache)
    zs_p = ZipServer(params, cfg, d, device="cpu", **kw)
    zs_r = RefZipServer(jparams, jcfg, d, **kw)
    try:
        out_lg, out_tok = _decode(zs_p, cfg)
        ref_lg, _ = serve_greedy(zs_r, cfg.vocab_size, STEPS, feed=out_tok,
                                 B=B, S=S)
        assert_greedy_agrees(out_lg, out_tok, ref_lg)
        assert zs_p._last_ids == zs_r._last_ids
        assert zs_p._moe_layers == zs_r._moe_layers == [1]
        for k in ("tokens_real", "tokens_padded"):
            assert zs_p.overlap_stats[k] == zs_r.overlap_stats[k], k
    finally:
        zs_p.close()
        zs_r.close()


def _record_routes(monkeypatch, cls, route_fn, out):
    """Wrap ``cls._zip_moe_ffn`` to append each continuous step's (layer,
    owners, top-k ids [B, k], probabilities [B, E]) to `out`."""
    orig = cls._zip_moe_ffn

    def recording(self, lp, x, layer_idx, owners=None):
        _, ti, probs = route_fn(lp["ffn"]["router"], x, self.cfg)
        out.append((layer_idx, list(owners), np.asarray(ti)[:, 0],
                    np.asarray(probs, np.float32)[:, 0]))
        return orig(self, lp, x, layer_idx, owners)

    monkeypatch.setattr(cls, "_zip_moe_ffn", recording)


def _first_flips(mine, theirs):
    """Per request, the first position whose routed experts differ between
    the two packages.  Every such difference must be a router near-tie:
    the reference's k-th and (k+1)-th probabilities closer than twice the
    two packages' largest probability difference on that row."""
    assert len(mine) == len(theirs) > 0
    seen, flips = {}, {}
    for (la, oa, ia, pa), (lb, ob, ib, pb) in zip(mine, theirs):
        assert (la, oa) == (lb, ob)
        for b, rid in enumerate(oa):
            pos = seen[rid, la] = seen.get((rid, la), -1) + 1
            if np.array_equal(np.sort(ia[b]), np.sort(ib[b])):
                continue
            top = np.sort(pb[b])[::-1]
            k = ib.shape[-1]
            assert top[k - 1] - top[k] <= 2 * np.abs(pa[b] - pb[b]).max(), \
                (rid, la, pos, ia[b], ib[b])
            flips[rid] = min(flips.get(rid, pos), pos)
    return flips


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["device", "host"])
def test_zipserver_decode_rows_matches_reference(lite_store, monkeypatch,
                                                 device_cache):
    """Continuous batching over ``decode_rows``: the same requests through
    both packages' ``BatchServer``s, the same batches in the same order,
    every route the same except at router near-ties; each request's logits
    within MAX_REL and its tokens equal where decided, up to its first
    near-tie flip (a flipped route takes another FFN, as in
    ``test_torch_cuda.py``);
    with no flip the per-request cache accounting equals the reference's."""
    jcfg, jparams, cfg, params, d = lite_store
    zs_kw = dict(pool_sizes=POOLS, device_cache=device_cache)
    prompts = _prompts(cfg, 1, (4, 7, 5))
    # all at once behind max_concurrency=2: the third request joins when
    # the first retires, at the same step in both packages whatever the
    # host's speed (an arrival time would race the steps' wall time)
    arrivals = [0.0, 0.0, 0.0]
    theirs, mine = [], []
    _record_routes(monkeypatch, RefZipServer, ref_moe.route, theirs)
    _record_routes(monkeypatch, ZipServer,
                   lambda w, x, c: [t.numpy() for t in route(w, x, c)], mine)
    # each prediction lands at the same drain in both packages, so the
    # cache accounting compared below does not depend on the host's speed
    settle_predictions(monkeypatch)
    zs_r = RefZipServer(jparams, jcfg, d, L=3, prefetch=True, **zs_kw)
    ref_srv = RefBatchServer(None, jcfg, max_batch=2, max_len=24,
                             zip_server=zs_r, max_concurrency=2, page_size=4)
    try:
        rids = [ref_srv.submit(p, 3, arrival_s=a, record_logits=True)
                for p, a in zip(prompts, arrivals)]
        by = {r.rid: r for r in ref_srv.run()}
        want = [by[r] for r in rids]
    finally:
        zs_r.close()
    got, srv, zs = _serve(cfg, params, d, prompts, zs_kw=zs_kw, cc=2,
                          arrivals=arrivals)
    flips = _first_flips(mine, theirs)
    compared = 0
    for a, b in zip(got, want):
        assert a.rid == b.rid and len(a.logits) == len(b.logits) == 3
        first = flips.get(a.rid, len(a.prompt) + 3) - (len(a.prompt) - 1)
        for t in range(min(first, 3)):
            x, y = a.logits[t], b.logits[t]
            diff = np.abs(x - y).max()
            assert diff <= MAX_REL * np.abs(y).max(), (a.rid, t, diff)
            compared += 1
            if a.output[t] != b.output[t]:
                top = np.sort(y)[::-1]
                assert top[0] - top[1] <= 2 * diff, (a.rid, t)
                break
    assert compared >= 5, (compared, flips)
    if not flips:
        got_rs, want_rs = srv.request_summary(), ref_srv.request_summary()
        for rid in got_rs:
            for key in ("cache_accesses", "cache_hits", "n_tokens"):
                assert got_rs[rid][key] == want_rs[rid][key], (rid, key)
    assert srv.pool.used_bytes() == 0


# ---------------------------------------------------------------------------
# within the port, bit for bit (depth 3: two MoE layers)
# ---------------------------------------------------------------------------
def _port_run(cfg, params, d, steps=STEPS, feed=None, replan_at=None, **kw):
    zs = ZipServer(params, cfg, d, device="cpu", L=3, **kw)
    try:
        lg, tok = serve_greedy(zs, cfg.vocab_size, steps, feed=feed,
                               replan_at=replan_at, B=B, S=S)
        return lg, tok, zs.overlap_summary(), zs
    finally:
        zs.close()


FFN_PATHS = {
    "grouped": dict(ffn_impl="grouped", device_cache=True),
    "fused-batched": dict(ffn_impl="grouped", fused_recovery=True),
    "fused-loop": dict(ffn_impl="loop", fused_recovery=True),
}


@pytest.mark.parametrize("path", list(FFN_PATHS))
def test_ffn_paths_bitidentical(lite3_store, path):
    """ragged ≡ grouped ≡ fused batched ≡ fused loop on the MLA model:
    every GEMM row is one f32 sum in k order whatever its weight source,
    and the combine is the same gather-sum."""
    _, _, cfg, params, d = lite3_store
    base = dict(pool_sizes=POOLS, prefetch=True)
    r_lg, r_tok, ov_r, _ = _port_run(cfg, params, d, device_cache=True,
                                     ffn_impl="ragged", **base)
    o_lg, o_tok, ov_o, _ = _port_run(cfg, params, d, **FFN_PATHS[path],
                                     **base)
    assert np.array_equal(r_lg, o_lg) and np.array_equal(r_tok, o_tok)
    assert ov_r["tokens_real"] == ov_o["tokens_real"] > 0


def test_loop_oracle_agrees(lite3_store):
    """The plain per-token loop (``ffn_impl="loop"``) is the validation
    oracle: a bf16 running sum with bf16 gates, as the JAX package's loop
    adds, so it is held to the ragged path within MAX_REL, not bit for
    bit (the JAX package pins only its fused loop bitwise)."""
    _, _, cfg, params, d = lite3_store
    base = dict(pool_sizes=POOLS, prefetch=True)
    r_lg, r_tok, _, _ = _port_run(cfg, params, d, device_cache=True,
                                  ffn_impl="ragged", **base)
    l_lg, _, _, _ = _port_run(cfg, params, d, feed=r_tok, ffn_impl="loop",
                              **base)
    assert_greedy_agrees(l_lg, r_tok, r_lg)


def test_device_cache_on_off_under_eviction(lite3_store):
    """Eviction-inducing pools and cross-layer prefetch over the two MoE
    layers: device slabs change no bit (the reference pins the same,
    tests/test_device_slab.py)."""
    _, _, cfg, params, d = lite3_store
    kw = dict(pool_sizes=TINY, prefetch=True, cross_layer_depth=1)
    on = _port_run(cfg, params, d, steps=6, device_cache=True, **kw)
    off = _port_run(cfg, params, d, steps=6, device_cache=False, **kw)
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])
    assert on[2]["slab_writes"] > 0 and off[2]["slab_writes"] == 0
    assert on[3].cache_summary()["evictions"] > 0


def _pin_consts(monkeypatch):
    """Pin both packages' planning constants (profiled u/c are host
    timings), and give the port the reference's IPF fit: on a stiff fit
    (an f entry projected to 1 - 1e-9, as layer 2's here) the reference's
    fit stops 5e-4 off and the port's finishes it
    (``tests/test_torch_planner.py::test_ipf_meets_bound_on_stiff_fits``),
    which moves the plan's cost; the rest of planning is held equal."""
    consts = dict(u=1.0, v=0.1, c=1.0, L=3, K=4, n_tensors=3)
    monkeypatch.setattr(ZipMoEEngine, "plan_consts",
                        lambda self, layer: PlanConsts(**consts))
    monkeypatch.setattr(RefEngine, "plan_consts",
                        lambda self, layer: RefConsts(**consts))
    monkeypatch.setattr(port_planner, "ipf_selection_probs",
                        ref_planner.ipf_selection_probs)


def test_planned_bitidentical_and_plan_matches_reference(lite3_store,
                                                         monkeypatch):
    """A ``mem_budget`` server (a forced re-plan mid-decode) gives the
    static ragged server's logits bit for bit; with the planning constants
    pinned in both packages, the reference's planned server fed the same
    tokens ends with the same ``plan_summary()``: per-layer plans (the
    dense layer's group (0, 0) planned as the reference plans it), the
    re-plan log and the resident bytes."""
    jcfg, jparams, cfg, params, d = lite3_store
    _pin_consts(monkeypatch)
    steps = 6
    dev = dict(device_cache=True, ffn_impl="ragged", prefetch=False)
    s_lg, s_tok, _, zs_s = _port_run(cfg, params, d, steps=steps,
                                     pool_sizes=TINY, **dev)
    budget = 6 * zs_s.engine._bytes_per_state(1)["F"]
    plan_kw = dict(mem_budget=budget, replan_every=2, plan_step=0.25)
    p_lg, p_tok, _, zs_p = _port_run(cfg, params, d, steps=steps,
                                     replan_at=3, **plan_kw, **dev)
    assert np.array_equal(s_lg, p_lg) and np.array_equal(s_tok, p_tok)
    zs_r = RefZipServer(jparams, jcfg, d, L=3, device_cache=True,
                        prefetch=False, **plan_kw)
    try:
        r_lg, _ = serve_greedy(zs_r, cfg.vocab_size, steps, feed=p_tok,
                               replan_at=3, B=B, S=S)
        assert_greedy_agrees(p_lg, p_tok, r_lg)
        a, b = zs_p.plan_summary(), zs_r.plan_summary()
    finally:
        zs_r.close()
    assert a["n_plans"] >= 2 and a["n_replans"] >= 1
    assert sorted(a["layers"]) == sorted(b["layers"]) == [0, 1, 2]
    assert a["layers"] == b["layers"]
    assert [(ev["step"], ev["reason"], ev["sizes"], ev["budgets"])
            for ev in a["replans"]] == \
        [(ev["step"], ev["reason"], ev["sizes"], ev["budgets"])
         for ev in b["replans"]]
    for key in ("bytes_occupancy", "bytes_resident", "n_plans", "n_replans",
                "mem_budget", "plan_steps"):
        assert a[key] == b[key], key
    assert a["bytes_resident"] <= budget + 1e-6


# ---------------------------------------------------------------------------
# KV page pool over the latent leaves
# ---------------------------------------------------------------------------
def test_page_pool_latent_pages(lite):
    _, _, cfg, _ = lite
    page = 4
    pool = KVPagePool(cfg, page_size=page, n_pages=6, max_slots=2,
                      device="cpu")
    per_layer = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * page
    assert pool.page_nbytes() == cfg.n_layers * per_layer
    assert pool.pool_bytes() == 6 * pool.page_nbytes()
    pool.alloc(1, 7)                                   # 2 pages
    pool.alloc(2, 3)                                   # 1 page
    assert pool.used_bytes() == 3 * pool.page_nbytes()
    ref = init_cache(cfg, 1, pool.capacity(1), device="cpu")
    rng = np.random.default_rng(5)
    for t in range(7):
        views = pool.gather([1, 2])
        assert views[0]["kv"]["ckv"].shape == (2, 8, cfg.kv_lora_rank)
        assert views[0]["kv"]["k_rope"].shape == (2, 8, cfg.qk_rope_dim)
        for lay_v, lay_r in zip(views, ref):
            for name in ("ckv", "k_rope"):
                val = torch.from_numpy(rng.standard_normal(
                    lay_r["kv"][name].shape[2:])).to(torch.bfloat16)
                lay_v["kv"][name][0, t] = val
                lay_r["kv"][name][0, t] = val
        pool.commit(views, [1, 2], np.asarray([t, t % 3]))
    final = pool.gather([1])
    for lay_f, lay_r in zip(final, ref):
        for name in ("ckv", "k_rope"):
            assert torch.equal(lay_f["kv"][name][:, :7].view(torch.int16),
                               lay_r["kv"][name][:, :7].view(torch.int16))
    pool.free(1)
    pool.free(2)
    assert pool.used_bytes() == 0 and pool.n_used_slots == 0
    grown = grow_cache(cfg, init_cache(cfg, 1, 3, device="cpu"), 1, 8)
    assert cache_bytes(grown) == cfg.n_layers * (
        cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * 8


# ---------------------------------------------------------------------------
# continuous ≡ solo on the latent pages
# ---------------------------------------------------------------------------
class LatentRecorder(Recorder):
    """test_torch_batching's Recorder with the pages read by leaf name
    (``ckv``, ``k_rope``) instead of ``k``/``v``."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        orig_free = _ORIG_FREE
        rec = self

        def free(self, rid):
            tab = torch.as_tensor(self._tables[rid])
            rec.pages[rid] = [
                tuple(lay["kv"][n][tab].reshape(
                    (-1,) + lay["kv"][n].shape[2:]).clone()
                    for n in sorted(lay["kv"]))
                for lay in self._paged]
            return orig_free(self, rid)

        monkeypatch.setattr(KVPagePool, "free", free)



@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_matches_solo(lite3_store, monkeypatch, mode):
    """The assertions of test_torch_batching, on the MLA model at depth 3:
    the latent pages each request committed in layer 0 bit-identical to
    its solo run's, every page, token and logit bit-identical wherever the
    router's probabilities were, routes where decided, tokens where
    decided, logits within MAX_REL."""
    _, _, cfg, params, d = lite3_store
    prompts = _prompts(cfg, 1, (4, 7, 5))
    rec = LatentRecorder(monkeypatch)
    batched, _, _ = _serve(cfg, params, d, prompts, zs_kw=MODES[mode],
                           cc=2, arrivals=[0.0, 0.0, 0.02])
    for r, p in zip(batched, prompts):
        solo_rec = LatentRecorder(monkeypatch)
        solo, _, _ = _serve(cfg, params, d, [p], zs_kw=MODES[mode], cc=1)
        assert len(solo[0].logits) == len(r.logits) == 3
        _, n = assert_same_request(r, solo[0], r.rid, solo[0].rid, rec,
                                   solo_rec)
        assert n >= 1 and len(rec.pages[r.rid][0]) == 2     # ckv, k_rope


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--arch", LITE, "--requests", "2", "--max-new",
       "2", "--prompt-len", "4", "--batch", "2"]


@pytest.mark.parametrize("mode,flags,lines", [
    ("resident", [], ["metrics:"]),
    ("zipmoe", ["--device-cache"],
     ["store:", "cache[hier]:", "overlap:", "transfer:", "gemm:"]),
    ("zipmoe-batch", ["--device-cache"],
     ["metrics:", "request[1]:", "request[2]:", "cache:", "overlap:",
      "transfer:", "gemm:"]),
])
def test_cli_modes(capsys, mode, flags, lines):
    from repro_torch.launch.serve import main
    main(CLI + ["--mode", mode] + flags)
    out = capsys.readouterr().out
    for line in lines:
        assert any(ln.startswith(line) for ln in out.splitlines()), \
            (line, out)
    assert "FAILED" not in out


# ---------------------------------------------------------------------------
# entry points refuse unsupported configs
# ---------------------------------------------------------------------------
_BASE = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
UNSUPPORTED = {
    # M-RoPE is served on GQA heads since qwen2-vl-2b; mla_forward takes
    # no M-RoPE positions, so an MLA config with it is still refused
    "mrope": dataclasses.replace(get_smoke_config(LITE, n_layers=2),
                                 mrope=True, embed_inputs=False),
    # learned positions are served in the encoder-decoders only
    "learned-pos": dataclasses.replace(_BASE, pos="learned"),
    # the hybrid family is served since jamba; one with ssm_state = 0 has
    # no Mamba2 state to carry and is still refused
    "hybrid": dataclasses.replace(_BASE, family="hybrid", attn_every=2,
                                  ssm_state=0),
    # the encoder-decoders are served since switch-large-128 with GQA
    # decoders; one of Mamba2 mixers is still refused
    "encoder-decoder": dataclasses.replace(
        get_smoke_config("jamba-v0.1-52b"), encoder_decoder=True,
        n_enc_layers=2),
    # tied embeddings are served; a config fed
    # embeddings has no token embedding to tie to and is still refused
    "tied-embeddings": dataclasses.replace(_BASE, tie_embeddings=True,
                                           embed_inputs=False),
}


def _cli_entry(cfg, monkeypatch):
    import repro_torch.launch.serve as serve_mod

    def no_work(*a, **k):
        raise AssertionError("the CLI did work before refusing")

    monkeypatch.setattr(serve_mod, "get_smoke_config", lambda *a, **k: cfg)
    monkeypatch.setattr(serve_mod, "init_params", no_work)
    serve_mod.main(["--device", "cpu", "--mode", "resident"])


ENTRY_POINTS = {
    # each is handed nothing it could work on: it must refuse first
    "ZipServer": lambda cfg, mp: ZipServer(None, cfg, "/nonexistent",
                                           device="cpu"),
    "params_from_jax": lambda cfg, mp: params_from_jax(None, cfg,
                                                       device="cpu"),
    "init_cache": lambda cfg, mp: init_cache(cfg, 1, 4, device="cpu"),
    "KVPagePool": lambda cfg, mp: KVPagePool(cfg, device="cpu"),
    "cli": _cli_entry,
}


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_refuses_unsupported(monkeypatch, entry, kind):
    with pytest.raises(NotImplementedError):
        ENTRY_POINTS[entry](UNSUPPORTED[kind], monkeypatch)


def test_numpy_params_draws_mla_trees():
    """The shared parameter helper draws both MLA configs' trees (the
    1-D f32 ``kv_norm`` and q-LoRA ``q_norm`` scales as ones)."""
    from repro.configs import get_smoke_config as ref_smoke
    for arch in (LITE, BIG):
        tree = numpy_params(ref_smoke(arch, **MLA))
        attn = tree["decoder"]["prefix"][0]["attn"]
        assert attn["kv_norm"].dtype == jnp.float32
        assert (np.asarray(attn["kv_norm"]) == 1).all()
        if arch == BIG:
            assert (np.asarray(attn["q_norm"]) == 1).all()
