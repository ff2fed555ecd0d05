"""The serving front end's building blocks against the JAX package, on the
same numpy-seeded parameters and inputs (the 2-layer smoke qwen2-moe):

* ``gqa_decode_rows`` (a position per row, T padded past the longest row),
  ``gqa_forward`` (plain and chunked), ``apply_moe`` (the same (token,
  slot) pairs dropped past the group capacity, bit for bit on the keep
  mask) and ``prefill``: outputs within ``MAX_REL`` of the largest
  reference magnitude, router ids identical — the packages add in other
  orders (test_torch_models);
* ``KVPagePool``: the JAX package's own pool tests — alloc/free/reuse,
  gather/commit bit-exact against a contiguous ``grow_cache`` layout,
  mixed-length gathers, an overflowing commit refused before any write;
* ``generate`` and the resident ``BatchServer``: greedy tokens agree with
  the reference's by teacher forcing (``assert_greedy_agrees``);
* the CLI (``repro_torch.launch.serve``) in its three modes on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
import repro.models.moe as ref_moe
from repro.models.model import decode_step as ref_decode_step
from repro.models.model import forward as ref_forward
from repro.models.model import prefill as ref_prefill
from repro.serving.generate import generate as ref_generate
from repro.serving.kv_cache import grow_cache as ref_grow_cache
from repro.serving.server import BatchServer as RefBatchServer
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.layers import apply_mlp
from repro_torch.serving.generate import generate, sample_tokens
from repro_torch.serving.kv_cache import (KVPagePool, cache_bytes,
                                          grow_cache, restack_layers,
                                          tree_leaves)
from repro_torch.serving.server import BatchServer
from test_torch_models import (MAX_REL, assert_greedy_agrees, both_params)


@pytest.fixture(scope="module")
def models():
    return both_params()


def _layer0(jparams, name):
    """Layer 0's sub-tree `name` of the JAX package's stacked decoder."""
    return jax.tree.map(lambda a: a[0],
                        jparams["decoder"]["stack"]["sub_0"][name])


def _bf16(a):
    """(jax bf16 array, torch bf16 tensor) of one f32 numpy array."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)


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


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_gqa_decode_rows_matches_reference(models):
    """Mixed positions in one batch, T padded past the longest row; the new
    K/V lands at (row, positions[row]) and nothing else of the cache
    changes."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(0)
    B, T = 4, 16
    positions = np.asarray([3, 9, 0, 5])
    jx, x = _bf16(rng.standard_normal((B, 1, cfg.d_model)))
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    jk, k = _bf16(rng.standard_normal(shape))
    jv, v = _bf16(rng.standard_normal(shape))
    cache = {"k": k.clone(), "v": v.clone()}
    want_y, want_kv = ref_attn.gqa_decode_rows(
        _layer0(jparams, "attn"), jx, jcfg, {"k": jk, "v": jv},
        jnp.asarray(positions, jnp.int32))
    y, got_kv = attn_lib.gqa_decode_rows(
        params["layers"][0]["attn"], x, cfg, cache,
        torch.from_numpy(positions))
    assert got_kv is cache
    _close(y, want_y, "y")
    rows = np.arange(B)
    for name, old in (("k", k), ("v", v)):
        got, want = cache[name], want_kv[name]
        _close(got[rows, positions], np.asarray(want)[rows, positions], name)
        keep = torch.ones(B, T, dtype=torch.bool)
        keep[rows, positions] = False
        assert torch.equal(got[keep].view(torch.int16),
                           old[keep].view(torch.int16)), name


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
def test_gqa_forward_matches_reference(models, monkeypatch, chunked):
    """Causal full-sequence attention with its K/V; ``chunked`` lowers the
    threshold in both packages so a 1024-token query runs as two chunks of
    ``Q_CHUNK`` = 512 rows."""
    jcfg, jparams, cfg, params = models
    B, S = 2, 32
    if chunked:
        for mod in (ref_attn, attn_lib):
            monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 2 * mod.Q_CHUNK)
        B, S = 1, 2 * attn_lib.Q_CHUNK
    jx, x = _bf16(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)))
    pos = np.broadcast_to(np.arange(S), (B, S))
    want_y, want_kv = ref_attn.gqa_forward(
        _layer0(jparams, "attn"), jx, jcfg, jnp.asarray(pos, jnp.int32),
        return_cache=True)
    y, kv = attn_lib.gqa_forward(params["layers"][0]["attn"], x, cfg,
                                 torch.from_numpy(pos.copy()),
                                 return_cache=True)
    _close(y, want_y, "y")
    for name in ("k", "v"):
        _close(kv[name], want_kv[name], name)


# ---------------------------------------------------------------------------
# MoE with capacity drops
# ---------------------------------------------------------------------------
def _ffn_both(jparams, params, router=None):
    jp = _layer0(jparams, "ffn")
    p = dict(params["layers"][0]["ffn"])
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        p["router"] = torch.from_numpy(router)
    return jp, p


@pytest.mark.parametrize("biased", [False, True], ids=["random", "biased"])
def test_apply_moe_matches_reference(models, biased):
    """``biased`` routes every token to experts 0 and 1, so both overflow
    their group capacity: the same (token, slot) pairs are dropped, and a
    token with every slot dropped gets the shared expert's output alone."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    B, S = 2, 32
    a = rng.standard_normal((B, S, cfg.d_model))
    router = None
    if biased:
        a = np.abs(a)                          # every token's sum > 0
        router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
        router[:, 0], router[:, 1] = 0.05, 0.04
    jx, x = _bf16(a)
    jp, p = _ffn_both(jparams, params, router)
    want_y, (want_i, want_probs) = ref_moe.apply_moe(jp, jx, jcfg)
    y, (top_i, probs) = moe_lib.apply_moe(p, x, cfg)
    assert np.array_equal(top_i.numpy(), np.asarray(want_i))
    _close(probs, want_probs, "probs")
    _close(y, want_y, "y")
    C = moe_lib.group_capacity(S, cfg)
    assert C == ref_moe.group_capacity(S, jcfg)
    pos = moe_lib._positions(top_i, cfg.n_experts).numpy()
    want_pos = np.asarray(ref_moe._positions(want_i, jcfg, B, S))
    assert np.array_equal(pos, want_pos)
    keep = pos < C
    assert np.array_equal(keep, want_pos < C)        # the same drops
    if not biased:
        return
    dropped = ~keep.any(-1)                           # [B, S]: all slots
    assert dropped.sum() == B * (S - C), dropped.sum()
    shared = apply_mlp(p["shared"], x, cfg)
    assert torch.equal(y[torch.from_numpy(dropped)].view(torch.int16),
                       shared[torch.from_numpy(dropped)].view(torch.int16))
    from repro.models.layers import apply_mlp as ref_apply_mlp
    want_shared = np.asarray(ref_apply_mlp(jp["shared"], jx, jcfg))
    assert np.array_equal(np.asarray(want_y)[dropped].view(np.uint16),
                          want_shared[dropped].view(np.uint16))


def test_apply_moe_scatter_refused(models):
    """The scatter dispatch is ported: it runs (tests/test_torch_training.py
    holds it against the reference); a dispatch neither package has is
    refused."""
    jcfg, jparams, cfg, params = models
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    ffn = params["layers"][0]["ffn"]
    y, _ = moe_lib.apply_moe(ffn, x, cfg, impl="scatter")
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    with pytest.raises(ValueError):
        moe_lib.apply_moe(ffn, x, cfg, impl="sparse")


# ---------------------------------------------------------------------------
# prefill / forward
# ---------------------------------------------------------------------------
NEAR_TIE = MAX_REL      # router probabilities closer than this may swap


def test_prefill_matches_reference(models, monkeypatch):
    """Logits, router ids and the per-layer K/V caches (restacked into the
    JAX package's layout), and the full pass's load-balance loss.  A router
    near-tie (the k-th and (k+1)-th reference probabilities within
    ``NEAR_TIE``) may pick another expert in the other package; that
    token's row is compared only before it (as the card tests in
    ``test_torch_cuda.py`` do)."""
    jcfg, jparams, cfg, params = models
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    seen = []
    orig = ref_moe.route

    def recording_route(router_w, x, c):
        out = orig(router_w, x, c)
        seen.append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    monkeypatch.setattr(ref_moe, "route", recording_route)
    want_lg, want_cache, want_aux = ref_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill", unroll=True)
    ids = []
    lg, caches = prefill(params, cfg, torch.from_numpy(toks), router_ids=ids)
    assert len(seen) == len(ids) == len(caches) == cfg.n_layers
    valid = np.ones((B, S), bool)       # rows/positions before any flip
    first_flip = cfg.n_layers
    for layer, (got_i, (want_i, probs)) in enumerate(zip(ids, seen)):
        differ = (np.sort(got_i.numpy(), -1) != np.sort(want_i, -1)).any(-1)
        top = np.sort(probs, -1)[..., ::-1]
        gap = top[..., cfg.top_k - 1] - top[..., cfg.top_k]
        assert (gap[differ] <= NEAR_TIE).all(), (layer, gap[differ])
        for b, s in zip(*np.nonzero(differ & valid)):
            valid[b, s:] = False
            first_flip = min(first_flip, layer)
    assert valid.sum() >= B * S - 2, valid
    got_lg, want_np = lg.float().numpy(), np.asarray(want_lg, np.float32)
    _close(got_lg[valid], want_np[valid], "logits")
    assert caches[0]["kv"]["k"].shape == (B, S, cfg.n_kv_heads, cfg.head_dim)
    stacked = restack_layers(caches, cfg)
    assert stacked["prefix"] == [] and stacked["stack"]["sub_0"]["kv"][
        "k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    want_kv = want_cache["stack"]["sub_0"]["kv"]
    for name in ("k", "v"):
        got = _np(stacked["stack"]["sub_0"]["kv"][name])
        want = _np(want_kv[name])
        for layer in range(cfg.n_layers):
            rows = valid if layer > first_flip else np.ones_like(valid)
            _close(got[layer][rows], want[layer][rows], name)
    full_lg, none, aux = forward(params, cfg, torch.from_numpy(toks))
    assert none is None
    assert torch.equal(full_lg.view(torch.int16), lg.view(torch.int16))
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-2)


def test_grow_cache_and_bytes(models):
    jcfg, jparams, cfg, params = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)))
    _, caches = prefill(params, cfg, toks)
    grown = grow_cache(cfg, caches, 2, 9)
    for c, g in zip(caches, grown):
        for name in ("k", "v"):
            assert g["kv"][name].shape[1] == 9
            assert torch.equal(g["kv"][name][:, :5].view(torch.int16),
                               c["kv"][name].view(torch.int16))
            assert not g["kv"][name][:, 5:].any()
    assert cache_bytes(grown) == cache_bytes(
        init_cache(cfg, 2, 9, device="cpu")) == cache_bytes(caches) * 9 // 5


# ---------------------------------------------------------------------------
# KV page pool (the JAX package's own pool tests)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cfg2():
    return get_smoke_config("qwen2-moe-a2.7b", n_layers=2)


def test_page_pool_alloc_free_reuse(cfg2):
    pool = KVPagePool(cfg2, page_size=4, n_pages=6, max_slots=2, device="cpu")
    pool.alloc(1, 10)                                  # 3 pages
    pool.alloc(2, 9)                                   # 3 pages
    assert pool.n_used_pages == 6 and pool.n_used_slots == 2
    assert pool.capacity(1) == 12 and pool.capacity(2) == 12
    with pytest.raises(RuntimeError):
        pool.alloc(3, 1)                               # exhausted (atomic)
    assert pool.summary()["n_requests"] == 2
    held1 = set(pool._tables[1])
    pool.free(1)
    assert pool.n_used_pages == 3
    pool.alloc(3, 12)                                  # reuses rid 1's pages
    assert set(pool._tables[3]) == held1
    pool.free(2)
    pool.free(3)
    assert pool.n_used_pages == 0 and pool.n_used_slots == 0
    assert pool.used_bytes() == 0                      # leak tripwire
    assert pool.summary()["n_requests"] == 0
    assert pool.pool_bytes() == 6 * pool.page_nbytes() > 0


def test_page_pool_vs_grow_cache(cfg2):
    """gather/commit round trips through the paged buffers equal a
    contiguous per-layer cache (the grow_cache layout) written at the same
    positions, bit for bit on the valid prefix."""
    pool = KVPagePool(cfg2, page_size=4, n_pages=8, max_slots=2, device="cpu")
    rid = 7
    pool.alloc(rid, 10)
    cap = pool.capacity(rid)                           # 12, page-aligned
    ref = init_cache(cfg2, 1, cap, device="cpu")
    rng = np.random.default_rng(5)
    for t in range(10):
        views = pool.gather([rid])
        for lay_v, lay_r in zip(views, ref):
            assert lay_v.keys() == lay_r.keys() == {"kv"}
            for name in ("k", "v"):
                assert lay_v["kv"][name].shape == lay_r["kv"][name].shape
                val = torch.from_numpy(rng.standard_normal(
                    lay_r["kv"][name].shape[2:])).to(torch.bfloat16)
                lay_v["kv"][name][:, t] = val
                lay_r["kv"][name][:, t] = val
        pool.commit(views, [rid], np.asarray([t]))
    final = pool.gather([rid])
    for lay_f, lay_r in zip(final, ref):
        for name in ("k", "v"):
            assert torch.equal(lay_f["kv"][name][:, :10].view(torch.int16),
                               lay_r["kv"][name][:, :10].view(torch.int16))


def test_page_pool_mixed_length_gather_and_overflow(cfg2):
    pool = KVPagePool(cfg2, page_size=4, n_pages=8, max_slots=3, device="cpu")
    pool.alloc(1, 4)                                   # 1 page
    pool.alloc(2, 11)                                  # 3 pages
    views = pool.gather([1, 2])
    for leaf in tree_leaves(views[0]["kv"]):
        assert leaf.shape[:2] == (2, 12)               # padded to max pages
    # short rows pad with their own first page
    page1 = pool._paged[0]["kv"]["k"][pool._tables[1][0]]
    for j in range(3):
        assert torch.equal(views[0]["kv"]["k"][0, 4 * j:4 * j + 4], page1)
    # a commit past a row's allocation refuses before writing anything
    before = [buf.clone() for buf in tree_leaves(pool._paged)]
    for leaf in tree_leaves(views):
        leaf.fill_(1.0)
    with pytest.raises(ValueError):
        pool.commit(views, [2, 1], np.asarray([5, 4]))
    for b, a in zip(before, tree_leaves(pool._paged)):
        assert torch.equal(a, b)
    pool.commit(views, [1, 2], np.asarray([3, 10]))  # the last valid slots
    assert pool._paged[0]["kv"]["k"][pool._tables[1][0], 3].eq(1).all()
    assert pool._paged[0]["kv"]["k"][pool._tables[2][2], 2].eq(1).all()


# ---------------------------------------------------------------------------
# generate and the resident BatchServer
# ---------------------------------------------------------------------------
def _forced_ref(jparams, jcfg, prompt, toks):
    """The JAX package's logits [N, B, 1, V] when prompt [B, S] is followed
    by the tokens toks [B, N] (teacher forcing)."""
    B, S = prompt.shape
    N = toks.shape[1]
    lg, cache = ref_prefill(jparams, jcfg,
                            {"tokens": jnp.asarray(prompt, jnp.int32)})
    cache = ref_grow_cache(jcfg, cache, B, S + N)
    out = [np.asarray(lg[:, -1:], np.float32)]
    for i in range(N - 1):
        lg, cache = ref_decode_step(
            jparams, jcfg, {"tokens": jnp.asarray(toks[:, i:i + 1],
                                                  jnp.int32)},
            cache, jnp.int32(S + i))
        out.append(np.asarray(lg, np.float32))
    return np.stack(out)


def _forced_port(params, cfg, prompt, toks):
    toks = np.array(toks)
    B, S = prompt.shape
    N = toks.shape[1]
    lg, caches = prefill(params, cfg, torch.from_numpy(prompt))
    caches = grow_cache(cfg, caches, B, S + N)
    out = [lg[:, -1:].float().numpy()]
    for i in range(N - 1):
        lg, caches = decode_step(params, cfg,
                                 torch.from_numpy(toks[:, i:i + 1]),
                                 caches, S + i)
        out.append(lg.float().numpy())
    return np.stack(out)


def _agree_until_undecided(got_tok, want_tok, want_logits):
    """Free-running streams: equal tokens up to the first step whose
    reference top-2 gap is within the bf16 noise of the two packages."""
    B, N = want_tok.shape
    for b in range(B):
        for i in range(N):
            top = np.sort(want_logits[i, b, -1])[::-1]
            if top[0] - top[1] <= MAX_REL * np.abs(want_logits).max():
                break
            assert got_tok[b, i] == want_tok[b, i], (b, i)


def test_generate_and_resident_server_match_reference(models):
    jcfg, jparams, cfg, params = models
    B, S, N = 2, 6, 5
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    want_all, _ = ref_generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new_tokens=N)
    want_tok = want_all[:, S:]
    got_all, m = generate(params, cfg, prompt, max_new_tokens=N)
    assert got_all.shape == (B, S + N) and m["ttft_s"] > 0
    assert np.array_equal(got_all[:, :S], prompt)
    got_tok = got_all[:, S:]
    want_lg = _forced_ref(jparams, jcfg, prompt, want_tok)
    got_lg = _forced_port(params, cfg, prompt, want_tok)
    assert_greedy_agrees(got_lg, got_lg[:, :, -1].argmax(-1).T, want_lg)
    _agree_until_undecided(got_tok, want_tok, want_lg)
    # the port's free-running stream is its own teacher-forced argmax
    own = _forced_port(params, cfg, prompt, got_tok)
    assert np.array_equal(own[:, :, -1].argmax(-1).T, got_tok)

    # the resident BatchServer serves the same bucket: the same tokens as
    # generate; the reference's server agrees as generate does
    srv = BatchServer(params, cfg, max_batch=B)
    ref_srv = RefBatchServer(jparams, jcfg, max_batch=B)
    for p in prompt:
        srv.submit(p, N)
        ref_srv.submit(p, N)
    done = sorted(srv.run(), key=lambda r: r.rid)
    ref_done = sorted(ref_srv.run(), key=lambda r: r.rid)
    assert np.array_equal(np.asarray([r.output for r in done]), got_tok)
    _agree_until_undecided(np.asarray([r.output for r in done]),
                           np.asarray([r.output for r in ref_done]), want_lg)
    m = srv.metrics()
    assert m["n_requests"] == B and m["mean_tpot_s"] > 0
    assert srv.cache_summary() == {} and all(
        d["n_tokens"] == N for d in srv.request_summary().values())


def test_sample_tokens_per_generator():
    """Greedy is the argmax; at a temperature each row draws from the
    generator it is given, so equal seeds give equal draws."""
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 50)).astype(np.float32))
    assert torch.equal(sample_tokens(logits), logits.argmax(-1))
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(11)
        draws.append(sample_tokens(logits, g, 1.0))
    assert torch.equal(draws[0], draws[1])
    assert draws[0].dtype == torch.int64 and draws[0].shape == (3,)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--requests", "2", "--max-new", "2",
       "--prompt-len", "4", "--batch", "2"]


@pytest.mark.parametrize("mode,flags,lines", [
    ("resident", [], ["metrics:"]),
    ("zipmoe", ["--device-cache"],
     ["store:", "cache[hier]:", "overlap:", "transfer:", "gemm:"]),
    ("zipmoe-batch", ["--device-cache", "--mem-budget", "2e6",
                      "--arrival-trace", "0,0.01"],
     ["metrics:", "request[1]:", "request[2]:", "cache:", "overlap:",
      "transfer:", "gemm:", "plan:"]),
    ("zipmoe-batch", ["--device-cache", "--spans"],
     ["metrics:", "transfer:", "spans: steps="]),
])
def test_cli_modes(capsys, mode, flags, lines):
    from repro_torch.launch.serve import main
    main(CLI + ["--mode", mode] + flags)
    out = capsys.readouterr().out
    for line in lines:
        assert any(ln.startswith(line) for ln in out.splitlines()), \
            (line, out)
    assert "FAILED" not in out


def test_cli_refuses_mesh(capsys, monkeypatch):
    """``--mesh 4`` on four ``cpu`` rows serves and prints the ``peer:``
    line with link-served experts; ``--mesh 2`` alone needs two cards and
    exits non-zero, naming the cards it found (none: the test hides any
    card this host may have)."""
    from repro_torch.launch.serve import main
    main(CLI + ["--mode", "zipmoe", "--device-cache", "--mesh", "4",
                "--peer-devices", "cpu,cpu,cpu,cpu"])
    peer = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("peer:")]
    assert len(peer) == 1, peer
    fields = dict(kv.split("=") for kv in peer[0].split()[1:])
    assert int(fields["served"]) > 0 and \
        int(fields["collective_bytes"]) > 0, peer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as ei:
        main(CLI + ["--mode", "zipmoe", "--mesh", "2"])
    assert ei.value.code != 0
    assert "needs 2 CUDA devices but 0 are visible (none)" in \
        str(ei.value.code)


def test_cli_mesh_rows_must_start_on_the_compute_device(monkeypatch):
    """With two cards visible, ``--mesh 2 --device cpu`` puts the first
    row on ``cuda:0`` while the model computes on the CPU: the CLI exits
    non-zero naming both, before it builds anything."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    for first, extra in (("cuda:0", []),
                         ("cuda:1", ["--peer-devices", "cuda:1,cpu"])):
        with pytest.raises(SystemExit) as ei:
            main(CLI + ["--mode", "zipmoe", "--mesh", "2"] + extra)
        assert f"peer device {first} is not the compute device cpu" in \
            str(ei.value.code), ei.value.code


def test_routing_trace_matches_reference(models, monkeypatch):
    """Per MoE layer and batch, the set of experts the routers activated:
    the reference's set, up to the experts of tokens whose router is at a
    near-tie (k-th and (k+1)-th probabilities within NEAR_TIE); and the
    plan fitted to a trace equals the reference's."""
    from repro.core.planner import PlanConsts as RefConsts
    from repro.serving.trace import collect_routing_trace as ref_trace
    from repro.serving.trace import fit_plan_from_trace as ref_fit
    from repro_torch.core.planner import PlanConsts
    from repro_torch.serving.trace import (collect_routing_trace,
                                           fit_plan_from_trace)
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, cfg.vocab_size, (2, 6)) for _ in range(3)]
    want = ref_trace(jparams, jcfg, batches)
    got = collect_routing_trace(params, cfg, batches)
    assert got.keys() == want.keys() == {0, 1}
    probs = []
    orig = ref_moe.route

    def recording_route(router_w, x, c):
        out = orig(router_w, x, c)
        probs.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(ref_moe, "route", recording_route)
    for i, toks in enumerate(batches):
        ref_forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                    unroll=True)
        for layer, p in zip(sorted(want), probs[-cfg.n_layers:]):
            p = p.reshape(-1, cfg.n_experts)
            top = np.argsort(p, -1)[:, ::-1]
            srt = np.take_along_axis(p, top, -1)
            tie = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k] <= NEAR_TIE
            ambiguous = set(top[tie, :cfg.top_k + 1].reshape(-1).tolist())
            assert got[layer][i] ^ want[layer][i] <= ambiguous, (i, layer)
    consts = dict(u=1e-3, v=1e-4, c=3e-4, L=4, K=4, n_tensors=3)
    bps = {"F": 4.0, "C": 3.0, "S": 2.0, "E": 1.0}
    plan = fit_plan_from_trace(want[0], cfg, 20.0, bps, PlanConsts(**consts))
    ref_plan = ref_fit(want[0], jcfg, 20.0, bps, RefConsts(**consts))
    assert plan.sizes == ref_plan.sizes
