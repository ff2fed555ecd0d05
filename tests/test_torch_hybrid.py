"""The SSM and hybrid families in the port (mamba2-370m, jamba-v0.1-52b at
their smoke widths), against the JAX package and against itself.

jamba's smoke config keeps its published layer pattern over one period of
8 layers: Mamba2 mixers everywhere but layer 3 (attention, no positional
encoding), MoE FFNs (8 experts top-2) on odd layers, dense MLPs on even
ones.  mamba2 runs 2 of its Mamba2 layers, FFN-less as published.  Parameters are drawn
with numpy from a seed and cross into the port through ``params_from_jax``.

* **Conversion and store**: every parameter bit-exact (the f32 Mamba2
  leaves stay f32); the store byte-identical to the reference's, with
  mamba2's projections ``{w_z, w_x, w_out}`` as each layer's group
  ``(l, 0)`` and jamba's dense MLPs as theirs.
* **ZipServer** ``decode_step`` (ragged, grouped and loop FFNs) against the
  reference's under teacher forcing, and continuous batching
  (``BatchServer`` over ``decode_rows``) against the reference's,
  compared on the first occupant of each slot: logits within ``MAX_REL``
  of the largest |logit| and tokens where decided
  (``test_torch_models.assert_greedy_agrees``).  A later occupant is not
  compared with the reference: its pool hands the next request the
  previous one's SSM state (``KVPagePool.alloc`` does not zero a slot).
* **A recycled slot** serves a request bit for bit as a fresh server
  serves it alone: the port's pool zeroes the slot's state at admission
  (without that this test fails).
* **KVPagePool** with slot leaves: the zeroing, and the byte accounting
  (pages, slots, used bytes back to 0), equal to the reference pool's.
* **The resident model** (``prefill`` through the SSD + ``decode_step``)
  against the reference's under teacher forcing, the resident
  ``BatchServer`` against it, and the CLI with ``--arch`` set to each.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.store import build_store as ref_build_store
from repro.models import decode_step as ref_decode_step
from repro.models.model import prefill as ref_prefill
from repro.serving.kv_cache import KVPagePool as RefPagePool
from repro.serving.kv_cache import cache_bytes as ref_cache_bytes
from repro.serving.kv_cache import grow_cache as ref_grow_cache
from repro.serving.kv_cache import unstack_layers as ref_unstack
from repro.serving.server import BatchServer as RefBatchServer
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.core.store import SSM_TENSORS, ExpertStore, build_store
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serving.kv_cache import (KVPagePool, cache_bytes,
                                          grow_cache, tree_leaves)
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer
from test_torch_batching import _prompts, assert_same_request
from test_torch_models import (MAX_REL, MEAN_REL, assert_greedy_agrees,
                               both_params, serve_greedy)

# mamba2 with d_ff = 0 as published (the smoke config's d_ff of 256 would
# give its layers an MLP): no FFN anywhere, its projections the store's
ARCHS = {"jamba": ("jamba-v0.1-52b", 8, {}),
         "mamba2": ("mamba2-370m", 2, {"d_ff": 0})}
POOLS = {"F": 2, "C": 2, "S": 4, "E": 8}
STEPS, B, S = 4, 2, 6


_BUILT = {}


def _setup(name, tmp_path_factory):
    """(name, JAX config, JAX params, port config, port params, reference
    store dir) of one family's smoke model, built once per module."""
    if name not in _BUILT:
        arch, n_layers, kw = ARCHS[name]
        jcfg, jparams, cfg, params = both_params(n_layers=n_layers,
                                                 arch=arch, **kw)
        d = str(tmp_path_factory.mktemp(f"store_{name}"))
        ref_build_store(jparams, jcfg, d, k_shards=4)
        _BUILT[name] = (name, jcfg, jparams, cfg, params, d)
    return _BUILT[name]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def family(request, tmp_path_factory):
    return _setup(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def jamba(tmp_path_factory):
    return _setup("jamba", tmp_path_factory)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# conversion and store
# ---------------------------------------------------------------------------
def test_params_from_jax_bitexact(family):
    name, jcfg, jparams, cfg, params, _ = family
    ref_layers = ref_unstack(jax.tree.map(np.asarray, jparams["decoder"]),
                             jcfg)
    assert len(ref_layers) == len(params["layers"]) == cfg.n_layers
    for i, (want, got) in enumerate(zip(ref_layers, params["layers"])):
        want, got = _flat(want), _flat(got)
        assert want.keys() == got.keys(), i
        for key, w in want.items():
            g = got[key]
            assert str(g.dtype).split(".")[-1] == w.dtype.name, (i, key)
            wb = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
            gb = g.view(torch.int16).numpy().view(np.uint16) \
                if g.dtype == torch.bfloat16 else g.numpy()
            assert np.array_equal(gb, wb), (i, key)
    kinds = ["mamba" if "mamba" in lp else "attn" for lp in params["layers"]]
    if name == "jamba":
        assert kinds == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
        assert params["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    else:
        assert kinds == ["mamba"] * cfg.n_layers
        assert all("ffn" not in lp for lp in params["layers"])


def test_store_bytes_match_reference(family, tmp_path):
    name, _, _, cfg, params, ref_dir = family
    build_store(params, cfg, str(tmp_path), k_shards=4, device="cpu",
                workers=2)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(tmp_path))
    _, mismatch, errors = filecmp.cmpfiles(ref_dir, str(tmp_path), names,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    st = ExpertStore(str(tmp_path))
    keys = sorted(st.groups)
    if name == "mamba2":         # every layer's SSM projections, expert 0
        assert keys == [(l, 0) for l in range(cfg.n_layers)]
        assert [t.name for t in st.groups[(0, 0)].tensors] == \
            list(SSM_TENSORS)
    else:                        # MoE on odd layers, dense MLPs on even
        want = [(l, e) for l in range(cfg.n_layers)
                for e in (range(cfg.n_experts) if l % 2 else [0])]
        assert keys == want
        assert st.groups[(0, 0)].full_bytes == 3 * cfg.d_model * cfg.d_ff * 2
    st.close()


# ---------------------------------------------------------------------------
# ZipServer against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,ffn_impl,device_cache", [
    ("jamba", "ragged", True), ("jamba", "grouped", False),
    ("jamba", "loop", False), ("mamba2", "ragged", True)],
    indirect=["family"])
def test_zipserver_decode_step_matches_reference(family, ffn_impl,
                                                 device_cache):
    """mamba2 has no routed FFN, so one FFN path covers it."""
    name, jcfg, jparams, cfg, params, d = family
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, ffn_impl=ffn_impl,
              device_cache=device_cache)
    zs_p = ZipServer(params, cfg, d, device="cpu", **kw)
    zs_r = RefZipServer(jparams, jcfg, d, **kw)
    try:
        out_lg, out_tok = serve_greedy(zs_p, cfg.vocab_size, STEPS, B=B,
                                       S=S)
        ref_lg, _ = serve_greedy(zs_r, cfg.vocab_size, STEPS, feed=out_tok,
                                 B=B, S=S)
        assert_greedy_agrees(out_lg, out_tok, ref_lg)
        assert zs_p._moe_layers == zs_r._moe_layers == (
            [1, 3, 5, 7] if name == "jamba" else [])
        assert zs_p._last_ids == zs_r._last_ids
    finally:
        zs_p.close()
        zs_r.close()


def _serve_port(cfg, params, d, prompts, cc, **zs_kw):
    zs = ZipServer(params, cfg, d, L=3, prefetch=True, device="cpu",
                   pool_sizes=POOLS, **zs_kw)
    srv = BatchServer(None, cfg, max_batch=cc, max_len=24, zip_server=zs,
                      max_concurrency=cc, page_size=4)
    try:
        rids = [srv.submit(p, 3, record_logits=True) for p in prompts]
        by = {r.rid: r for r in srv.run()}
        assert srv.pool.used_bytes() == 0
        return [by[r] for r in rids]
    finally:
        zs.close()


def _serve_ref(jcfg, jparams, d, prompts, cc, **zs_kw):
    zs = RefZipServer(jparams, jcfg, d, L=3, prefetch=True,
                      pool_sizes=POOLS, **zs_kw)
    srv = RefBatchServer(None, jcfg, max_batch=cc, max_len=24,
                         zip_server=zs, max_concurrency=cc, page_size=4)
    try:
        rids = [srv.submit(p, 3, record_logits=True) for p in prompts]
        by = {r.rid: r for r in srv.run()}
        return [by[r] for r in rids]
    finally:
        zs.close()


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["device", "host"])
def test_continuous_matches_reference_first_occupants(family, device_cache):
    """Four requests, two slots: requests 1 and 2 are their slots' first
    occupants and are held against the reference; 3 and 4 run in recycled
    slots (see test_recycled_slot_matches_alone)."""
    _, jcfg, jparams, cfg, params, d = family
    prompts = _prompts(cfg, 1, (4, 7, 5, 6))
    got = _serve_port(cfg, params, d, prompts, 2, device_cache=device_cache)
    want = _serve_ref(jcfg, jparams, d, prompts, 2,
                      device_cache=device_cache)
    for a, b in zip(got, want):
        assert a.rid == b.rid and len(a.logits) == len(b.logits) == 3
        assert a.error is None
    for a, b in zip(got[:2], want[:2]):
        _, n = assert_same_request(a, b, a.rid, b.rid)
        assert n >= 1


@pytest.mark.parametrize("cc", [1, 2])
def test_recycled_slot_matches_alone(family, cc):
    """Request B served in a slot that request A held before it: its
    logits bit for bit those of B alone on a fresh server, its tokens the
    same.  With one slot B follows A in it; with two, the third request
    takes the first slot freed.  At the smoke widths every product of a
    step is batch-invariant on the CPU (test_torch_batching), so batch
    neighbours change no bit either."""
    _, _, _, cfg, params, d = family
    prompts = _prompts(cfg, 3, (5, 4, 6))
    shared = _serve_port(cfg, params, d, prompts, cc, device_cache=True)
    for r, p in zip(shared[cc:], prompts[cc:]):
        alone = _serve_port(cfg, params, d, [p], 1, device_cache=True)[0]
        assert r.output == alone.output
        for x, y in zip(r.logits, alone.logits):
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the page pool's slot leaves
# ---------------------------------------------------------------------------
def test_page_pool_zeroes_slot_at_alloc(jamba):
    """A request's slot leaves start at zero although the slot's previous
    owner left its state there; pages keep their bytes (masking hides
    them)."""
    _, _, _, cfg, _, _ = jamba
    pool = KVPagePool(cfg, page_size=4, n_pages=2, max_slots=1,
                      device="cpu")
    pool.alloc(1, 4)
    views = pool.gather([1])
    for view in views:
        for leaf in tree_leaves(view):
            leaf.fill_(1)
    pool.commit(views, [1], [0])
    assert all(bool((x == 1).all()) for x in tree_leaves(pool._slot))
    pool.free(1)
    pool.alloc(2, 4)
    views = pool.gather([2])
    assert all(bool((leaf == 0).all()) for v in views
               for leaf in tree_leaves(v.get("ssm", {})))
    page = pool._tables[2][0]
    assert bool((pool._paged[3]["kv"]["k"][page, 0] == 1).all())
    assert pool.used_bytes() == pool.page_nbytes() + pool.slot_nbytes()


def test_page_pool_accounting_with_slots(family):
    name, jcfg, _, cfg, _, _ = family
    pool = KVPagePool(cfg, page_size=4, n_pages=6, max_slots=3,
                      device="cpu")
    ref = RefPagePool(jcfg, page_size=4, n_pages=6, max_slots=3)
    c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    per_ssm = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4 \
        + (cfg.ssm_conv - 1) * c * 2
    n_attn = 1 if name == "jamba" else 0
    assert pool.slot_nbytes() == (cfg.n_layers - n_attn) * per_ssm
    assert pool.page_nbytes() == n_attn * 4 * 2 * cfg.n_kv_heads \
        * cfg.head_dim * 2
    assert pool.slot_nbytes() == ref.slot_nbytes()
    assert pool.page_nbytes() == ref.page_nbytes()
    assert pool.pool_bytes() == ref.pool_bytes() == \
        6 * pool.page_nbytes() + 3 * pool.slot_nbytes()
    pool.alloc(1, 5)
    pool.alloc(2, 3)
    assert pool.used_bytes() == 3 * pool.page_nbytes() \
        + 2 * pool.slot_nbytes()
    views = pool.gather([1, 2])
    assert views[0]["ssm"]["state"].shape == (
        2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    pool.free(1)
    pool.free(2)
    assert pool.used_bytes() == 0


def test_grow_cache_and_cache_bytes_with_ssm(jamba):
    """A jamba prefill's caches grow to the decode length: the attention
    layer's K/V pad with zeros, the SSM leaves copy whole; the byte count
    of an empty cache equals the reference's."""
    _, jcfg, _, cfg, params, _ = jamba
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 5)))
    _, caches = prefill(params, cfg, toks)
    grown = grow_cache(cfg, caches, 2, 9)
    for c, g in zip(caches, grown):
        if "ssm" in c:
            for k in ("state", "conv"):
                assert torch.equal(g["ssm"][k], c["ssm"][k])
        else:
            assert g["kv"]["k"].shape[1] == 9
            assert torch.equal(g["kv"]["k"][:, :5], c["kv"]["k"])
            assert bool((g["kv"]["k"][:, 5:] == 0).all())
    from repro.models import init_cache as ref_init_cache
    assert cache_bytes(init_cache(cfg, 2, 9, device="cpu")) == \
        ref_cache_bytes(ref_init_cache(jcfg, 2, 9))


# ---------------------------------------------------------------------------
# the resident model and the CLI
# ---------------------------------------------------------------------------
def _forced(step_pf, step_dec, grow, prompt, toks):
    """Logits [N, B, 1, V] of prompt [B, S] followed by toks [B, N]."""
    Bq, Sq = prompt.shape
    N = toks.shape[1]
    lg, cache = step_pf(prompt)
    cache = grow(cache, Bq, Sq + N)
    out = [np.asarray(lg[:, -1:].float() if torch.is_tensor(lg)
                      else lg[:, -1:], np.float32)]
    for i in range(N - 1):
        lg, cache = step_dec(toks[:, i:i + 1], cache, Sq + i)
        out.append(np.asarray(lg.float() if torch.is_tensor(lg) else lg,
                              np.float32))
    return np.stack(out)


def test_resident_model_matches_reference(family):
    """``prefill`` (the SSD over the prompt) then ``decode_step`` against
    the JAX package's, teacher-forced on the port's greedy tokens, and the
    resident ``BatchServer`` serving those tokens."""
    _, jcfg, jparams, cfg, params, _ = family
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (B, S))
    srv = BatchServer(params, cfg, max_batch=B)
    for row in prompt:
        srv.submit(row, STEPS)
    done = sorted(srv.run(), key=lambda r: r.rid)
    toks = np.asarray([r.output for r in done])
    got = _forced(lambda p: prefill(params, cfg, torch.from_numpy(p)),
                  lambda t, c, pos: decode_step(params, cfg,
                                                torch.from_numpy(t), c, pos),
                  lambda c, b, n: grow_cache(cfg, c, b, n), prompt, toks)
    want = _forced(
        lambda p: ref_prefill(jparams, jcfg,
                              {"tokens": jnp.asarray(p, jnp.int32)},
                              unroll=True),
        lambda t, c, pos: ref_decode_step(
            jparams, jcfg, {"tokens": jnp.asarray(t, jnp.int32)}, c,
            jnp.int32(pos), unroll=True),
        lambda c, b, n: ref_grow_cache(jcfg, c, b, n), prompt, toks)
    diff = np.abs(got - want)
    assert diff.max() <= MAX_REL * np.abs(want).max()
    assert diff.mean() <= MEAN_REL * np.abs(want).max()
    # the server's tokens are the greedy ones of its own logits
    assert np.array_equal(np.argmax(got[:, :, -1], -1).T, toks)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-370m"])
def test_cli_serves_family(capsys, arch):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", arch, "--mode", "zipmoe-batch",
          "--device-cache", "--requests", "2", "--max-new", "2",
          "--prompt-len", "4", "--batch", "2"])
    out = capsys.readouterr().out
    for head in ("store:", "metrics:", "request[1]:", "request[2]:",
                 "cache:", "overlap:"):
        assert any(ln.startswith(head) for ln in out.splitlines()), \
            (head, out)
    assert "FAILED" not in out
