"""The encoder-decoder family in the port (switch-large-128, the paper's
third evaluation model, and whisper-small at their smoke widths) against
the JAX package.

Parameters are drawn with numpy from a seed (``test_torch_models.
numpy_params``: the learned position table at the JAX init's 0.02) and
cross into the port through ``params_from_jax``; the batches come from
``make_batch`` with a numpy seed, bit-equal in both packages.

* the resident model: ``forward``, ``prefill`` and ``decode_step`` of both
  configs against the reference's, in bf16 within ``MAX_REL`` (2%) of the
  largest |logit| at worst and ``MEAN_REL`` (0.5%) on average (bf16
  weights, f32 norms and softmax, other add orders), in f32 within 1e-4;
  the port's own ``prefill(S-1)`` + ``decode_step`` ≡ ``forward(S)``
  within 1e-4 in f32, the reference's bound (tests/test_models.py);
* switch's ``ZipServer.decode_step`` (ragged, grouped and loop FFNs;
  ``device_cache`` on and off) after a resident prefill over the encoder
  inputs, against the reference's resident ``decode_step`` fed the same
  tokens: routes equal and logits within 2%; ragged and grouped
  bit-identical, the loop oracle (bf16 adds, as the reference's) within
  2% of them; the caches it returns hold the prefill's ``xkv``
  unchanged.  (The reference's own ``ZipServer`` skips the
  cross-attention; the port's does not copy that.)
* switch's store files byte-equal to the reference's; whisper's
  ``ZipServer`` (no routed expert) ≡ its resident model bit for bit;
* the per-entry refusals of configs with no reference path: ``decode_rows``,
  ``BatchServer``, ``KVPagePool`` and the CLI on switch and qwen2-vl-2b,
  ``ZipServer`` on qwen2-vl-2b.
"""
import dataclasses
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import ShapeConfig as RefShape
from repro.core.store import build_store as ref_build_store
from repro.models import decode_step as ref_decode_step
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.model import forward as ref_forward
from repro.serving.kv_cache import grow_cache as ref_grow_cache
from repro.serving.kv_cache import unstack_layers as ref_unstack_layers
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.store import build_store
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.inputs import make_batch
from repro_torch.models.model import refusal
from repro_torch.serving.generate import generate
from repro_torch.serving.kv_cache import KVPagePool, grow_cache
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import MAX_REL, MEAN_REL, both_params

SWITCH, WHISPER, VLM = "switch-large-128", "whisper-small", "qwen2-vl-2b"
ENCDEC = [SWITCH, WHISPER]
F32_REL = 1e-4
B, S, STEPS = 2, 8, 3
POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}


def _params(arch, dtype="bfloat16", seed=0):
    # f32: no capacity drops either, so a prefill and a decode step route
    # every token as the full pass does
    kw = dict(dtype="float32", capacity_factor=8.0) if dtype == "float32" \
        else {}
    return both_params(n_layers=4, seed=seed, arch=arch, **kw)


def _ref_batch(jcfg, kind="prefill", seq=S):
    return ref_make_batch(jcfg, RefShape("t", seq, B, kind), kind, seed=1)


def _batch(cfg, kind="prefill", seq=S):
    return make_batch(cfg, ShapeConfig("t", seq, B, kind), kind, seed=1,
                      device="cpu")


def _assert_close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    diff = np.abs(got - want)
    scale = np.abs(want).max()
    if dtype == "float32":
        assert diff.max() <= F32_REL * scale, (what, diff.max(), scale)
    else:
        assert diff.max() <= MAX_REL * scale, (what, diff.max(), scale)
        assert diff.mean() <= MEAN_REL * scale, (what, diff.mean(), scale)


def _prefix(batch, n):
    """The batch's first `n` decoder positions (encoder inputs whole)."""
    return {k: (v if k == "enc_embeds" else v[:, :n]) for k, v in
            batch.items() if k != "labels"}


def _port_inputs(b):
    return dict(enc_embeds=b["enc_embeds"])


def test_numpy_params_draws_encdec_trees():
    """The shared parameter helper draws the encoder stack, ``enc_norm``,
    the decoder's ``norm_x``/``xattn`` and the learned position table, the
    table at the JAX init's 0.02 (by its shape alone it would be drawn at
    (2 / (rows + cols))^0.5 ≈ 0.008)."""
    jcfg, jparams, cfg, params = _params(SWITCH)
    pos = np.asarray(jparams["embed"]["pos"], np.float32)
    assert pos.shape == (32768, cfg.d_model)
    assert 0.019 < pos.std() < 0.021, pos.std()
    assert (np.asarray(jparams["enc_norm"]["scale"]) == 1).all()
    sub = jparams["decoder"]["stack"]["sub_1"]
    assert (np.asarray(sub["norm_x"]["scale"]) == 1).all()
    assert sub["xattn"]["wk"].shape[-1] == cfg.n_heads * cfg.head_dim
    assert len(params["encoder"]) == cfg.n_enc_layers == 2
    for lp in params["layers"]:
        assert {"norm_x", "xattn"} <= lp.keys()
    assert "router" in params["layers"][1]["ffn"]
    assert "router" not in params["layers"][0]["ffn"]
    assert torch.equal(params["embed"]["pos"].float(), torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ENCDEC)
def test_resident_matches_reference(arch, dtype):
    """``forward`` over a batch, then ``prefill`` of its first S-1 tokens
    and ``decode_step`` of the last one, in both packages."""
    jcfg, jparams, cfg, params = _params(arch, dtype)
    jb, tb = _ref_batch(jcfg), _batch(cfg)
    jl, _, _ = ref_forward(jparams, jcfg, jb, unroll=True)
    tl, _, _ = forward(params, cfg, tb["tokens"], **_port_inputs(tb))
    _assert_close(tl, jl, dtype, "forward")
    jl, jc = ref_forward(jparams, jcfg, _prefix(jb, S - 1), mode="prefill",
                         unroll=True)[:2]
    tl, tc = prefill(params, cfg, tb["tokens"][:, :S - 1],
                     **_port_inputs(tb))
    _assert_close(tl, jl, dtype, "prefill")
    jc = ref_grow_cache(jcfg, jc, B, S)
    tc = grow_cache(cfg, tc, B, S)
    jl, _ = ref_decode_step(jparams, jcfg,
                            {"tokens": jb["tokens"][:, S - 1:]}, jc,
                            jnp.int32(S - 1), unroll=True)
    tl, _ = decode_step(params, cfg, tb["tokens"][:, S - 1:], tc, S - 1)
    _assert_close(tl, jl, dtype, "decode_step")


@pytest.mark.parametrize("arch", ENCDEC)
def test_prefill_decode_matches_forward_f32(arch):
    """The port alone: ``prefill(S-1)`` + ``decode_step`` ≡ ``forward(S)``
    within 1e-4 in f32 (the JAX package's own bound)."""
    _, _, cfg, params = _params(arch, "float32")
    tb = _batch(cfg)
    want, _, _ = forward(params, cfg, tb["tokens"], **_port_inputs(tb))
    _, caches = prefill(params, cfg, tb["tokens"][:, :S - 1],
                        **_port_inputs(tb))
    caches = grow_cache(cfg, caches, B, S)
    got, _ = decode_step(params, cfg, tb["tokens"][:, S - 1:], caches, S - 1)
    _assert_close(got[:, 0], want[:, -1].numpy(), "float32", arch)


def test_grow_cache_holds_xkv():
    """``grow_cache`` copies the cross-attention's K/V whole: it already
    has its final shape [B, enc_seq_len, H, D]."""
    _, _, cfg, params = _params(SWITCH)
    tb = _batch(cfg)
    _, caches = prefill(params, cfg, tb["tokens"], **_port_inputs(tb))
    grown = grow_cache(cfg, caches, B, S + 4)
    for c, g in zip(caches, grown):
        assert g["kv"]["k"].shape[1] == S + 4
        for name in ("k", "v"):
            assert g["xkv"][name].shape == (B, cfg.enc_seq_len, cfg.n_heads,
                                            cfg.head_dim)
            assert torch.equal(g["xkv"][name], c["xkv"][name])
    empty = init_cache(cfg, B, S, device="cpu")
    assert all(c["xkv"]["k"].shape == grown[0]["xkv"]["k"].shape
               for c in empty)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ENCDEC)
def test_make_batch_matches_reference(arch, kind):
    jcfg, _, cfg, _ = _params(arch)
    jb, tb = _ref_batch(jcfg, kind), _batch(cfg, kind)
    assert jb.keys() == tb.keys()
    for name, v in jb.items():
        want = np.asarray(v)
        got = tb[name]
        if v.dtype == jnp.bfloat16:
            want, got = want.view(np.uint16), got.view(torch.int16).numpy()
            got = got.view(np.uint16)
        else:
            got = got.numpy()
        assert got.shape == want.shape and np.array_equal(got, want), name


def test_generate_takes_encoder_inputs():
    """``generate`` hands ``extra_inputs`` to the prefill: its tokens are
    the greedy tokens of ``prefill`` over the encoder inputs and
    ``decode_step``s."""
    _, _, cfg, params = _params(SWITCH)
    tb = _batch(cfg)
    toks, _ = generate(params, cfg, tb["tokens"], max_new_tokens=3,
                       extra_inputs=_port_inputs(tb))
    lg, caches = prefill(params, cfg, tb["tokens"], **_port_inputs(tb))
    caches = grow_cache(cfg, caches, B, S + 3)
    tok = lg[:, -1].argmax(-1)
    want = [tok]
    for i in range(2):
        lg, caches = decode_step(params, cfg, tok[:, None], caches, S + i)
        tok = lg[:, -1].argmax(-1)
        want.append(tok)
    assert np.array_equal(toks[:, S:], torch.stack(want, 1).numpy())
    assert np.array_equal(toks[:, :S], tb["tokens"].numpy())


# ---------------------------------------------------------------------------
# the store and ZipServer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def switch_store(tmp_path_factory):
    """switch at depth 4 (dense at 0 and 2, MoE at 1 and 3) with the
    reference's store."""
    jcfg, jparams, cfg, params = _params(SWITCH)
    d = str(tmp_path_factory.mktemp("store_switch"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


def test_store_bytes_match_reference(switch_store, tmp_path):
    """The store walks only ``ffn`` (and ``mamba``): the encoder, the
    cross-attention and the norms stay resident, as in the reference."""
    _, _, cfg, params, ref_dir = switch_store
    store = build_store(params, cfg, str(tmp_path), k_shards=4, device="cpu",
                        workers=2)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(tmp_path))
    _, mismatch, errors = filecmp.cmpfiles(ref_dir, str(tmp_path), names,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    keys = sorted(store.groups)
    assert keys == sorted([(0, 0), (2, 0)]
                          + [(l, e) for l in (1, 3)
                             for e in range(cfg.n_experts)])
    # a GELU expert: w_up and w_down, no gate
    assert store.groups[(1, 0)].full_bytes == 2 * cfg.d_model \
        * cfg.d_expert * 2
    store.close()


def _serve_switch(cfg, params, d, feed=None, **kw):
    """Resident prefill over the encoder inputs, then STEPS greedy
    ``ZipServer.decode_step``s (or fed `feed` [B, STEPS]).  Returns the
    step logits [STEPS, B, 1, V], the tokens fed [B, STEPS], the
    ZipServer's routes per step and MoE layer, the prefill's ``xkv`` and
    the final caches."""
    tb = _batch(cfg)
    lg, caches = prefill(params, cfg, tb["tokens"], **_port_inputs(tb))
    xkv = [{n: c["xkv"][n].clone() for n in ("k", "v")} for c in caches]
    caches = grow_cache(cfg, caches, B, S + STEPS)
    zs = ZipServer(params, cfg, d, device="cpu", L=3, pool_sizes=POOLS,
                   prefetch=True, **kw)
    tok = lg[:, -1].argmax(-1)[:, None]
    logits, toks = [], []
    try:
        for i in range(STEPS):
            if feed is not None:
                tok = torch.from_numpy(feed[:, i:i + 1])
            toks.append(tok.numpy())
            out, caches = zs.decode_step(tok, caches, S + i)
            tok = out[:, -1].argmax(-1)[:, None]
            logits.append(out.float().numpy())
        routes = [s["routes"] for s in zs.stats]
    finally:
        zs.close()
    return (np.stack(logits), np.concatenate(toks, 1), routes, xkv, caches,
            tb)


def _ref_resident(jcfg, jparams, feed, monkeypatch):
    """The reference's resident prefill + ``decode_step``s fed `feed`
    [B, STEPS]: logits and the routes of every MoE layer, in step
    order."""
    seen = []
    orig = ref_moe.route

    def recording(router_w, x, c):
        out = orig(router_w, x, c)
        if x.shape[1] == 1:                  # decode steps only
            seen.append(np.asarray(out[1]).reshape(B, -1))
        return out

    monkeypatch.setattr(ref_moe, "route", recording)
    jb = _ref_batch(jcfg)
    _, jc = ref_forward(jparams, jcfg, jb, mode="prefill", unroll=True)[:2]
    jc = ref_grow_cache(jcfg, jc, B, S + STEPS)
    logits = []
    for i in range(STEPS):
        tok = jnp.asarray(feed[:, i:i + 1], jnp.int32)
        out, jc = ref_decode_step(jparams, jcfg, {"tokens": tok}, jc,
                                  jnp.int32(S + i), unroll=True)
        logits.append(np.asarray(out, np.float32))
    return np.stack(logits), seen


SWITCH_PATHS = [(impl, dc) for dc in (True, False)
                for impl in ("ragged", "grouped", "loop")]


@pytest.mark.parametrize("ffn_impl,device_cache", SWITCH_PATHS,
                         ids=[f"{i}-{'device' if dc else 'host'}"
                              for i, dc in SWITCH_PATHS])
def test_zipserver_matches_reference_resident(switch_store, monkeypatch,
                                              ffn_impl, device_cache):
    """switch's ``ZipServer.decode_step`` with cross-attention, against
    the reference's resident ``decode_step`` on the same tokens: the same
    routes at every step and MoE layer, logits within MAX_REL; the caches
    returned still hold the prefill's ``xkv``, unchanged."""
    jcfg, jparams, cfg, params, d = switch_store
    lg, toks, routes, xkv, caches, _ = _serve_switch(
        cfg, params, d, ffn_impl=ffn_impl, device_cache=device_cache)
    want, seen = _ref_resident(jcfg, jparams, toks, monkeypatch)
    diff = np.abs(lg - want)
    scale = np.abs(want).max()
    assert diff.max() <= MAX_REL * scale, (diff.max(), scale)
    assert diff.mean() <= MEAN_REL * scale, (diff.mean(), scale)
    assert len(routes) == len(seen) == STEPS * 2
    for mine, theirs in zip(routes, seen):
        assert np.array_equal(np.sort(mine, -1), np.sort(theirs, -1))
    for c, x in zip(caches, xkv):
        for name in ("k", "v"):
            assert torch.equal(c["xkv"][name], x[name])


def test_reference_zipserver_drops_cross_attention(switch_store):
    """The JAX package's defect that the port does not copy: its
    ``ZipServer.decode_step`` has no cross-attention step and returns
    caches without ``xkv``, so one step after its own resident prefill its
    logits part from its own resident ``decode_step`` far beyond bf16
    noise (the port's agree within MAX_REL, tests above)."""
    jcfg, jparams, _, _, d = switch_store
    jl, jc = ref_forward(jparams, jcfg, _ref_batch(jcfg), mode="prefill",
                         unroll=True)[:2]
    jc = ref_grow_cache(jcfg, jc, B, S + 1)
    tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    want, _ = ref_decode_step(jparams, jcfg, {"tokens": tok}, jc,
                              jnp.int32(S), unroll=True)
    zs = RefZipServer(jparams, jcfg, d, L=3, pool_sizes=POOLS)
    try:
        got, caches = zs.decode_step(tok, ref_unstack_layers(jc, jcfg), S)
    finally:
        zs.close()
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel > 10 * MAX_REL, rel
    assert not any("xkv" in c for c in caches)


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["device", "host"])
def test_zipserver_paths_bit_identical(switch_store, device_cache):
    """Within the port the ragged and grouped FFNs give the same bits
    (every GEMM row one f32 sum in k order), fed the same tokens; the
    per-token loop oracle adds in bf16, as the JAX package's loop does,
    and is held within MAX_REL of them."""
    _, _, cfg, params, d = switch_store
    base, toks = _serve_switch(cfg, params, d, ffn_impl="ragged",
                               device_cache=device_cache)[:2]
    lg = _serve_switch(cfg, params, d, feed=toks, ffn_impl="grouped",
                       device_cache=device_cache)[0]
    assert np.array_equal(lg.view(np.uint32), base.view(np.uint32))
    lg = _serve_switch(cfg, params, d, feed=toks, ffn_impl="loop",
                       device_cache=device_cache)[0]
    diff = np.abs(lg - base)
    assert diff.max() <= MAX_REL * np.abs(base).max(), diff.max()


def test_zipserver_whisper_bit_identical_to_resident(tmp_path):
    """whisper has no routed expert: its dense FFNs stay resident (the
    store still holds them as groups ``(layer, 0)``), so ``ZipServer.
    decode_step`` is the resident ``decode_step`` bit for bit."""
    _, _, cfg, params = _params(WHISPER)
    store = build_store(params, cfg, str(tmp_path), device="cpu", workers=2)
    assert sorted(store.groups) == [(l, 0) for l in range(cfg.n_layers)]
    store.close()
    tb = _batch(cfg)
    _, caches = prefill(params, cfg, tb["tokens"], **_port_inputs(tb))
    mine = grow_cache(cfg, caches, B, S + STEPS)
    ref = grow_cache(cfg, caches, B, S + STEPS)
    zs = ZipServer(params, cfg, str(tmp_path), device="cpu", L=3,
                   pool_sizes=POOLS, device_cache=True)
    tok = tb["tokens"][:, -1:]
    try:
        for i in range(STEPS):
            got, mine = zs.decode_step(tok, mine, S + i)
            want, ref = decode_step(params, cfg, tok, ref, S + i)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
            tok = got[:, -1].argmax(-1)[:, None]
    finally:
        zs.close()


# ---------------------------------------------------------------------------
# entry points with no reference path refuse, before any work
# ---------------------------------------------------------------------------
def _refused_cfg(arch):
    return get_smoke_config(arch, n_layers=4)


def _decode_rows(arch, tmp_path, monkeypatch):
    cfg = _refused_cfg(arch)
    if arch == VLM:      # the server itself refuses: decode_rows is unreachable
        ZipServer(None, cfg, "/nonexistent", device="cpu")
    _, _, cfg, params = _params(arch)
    build_store(params, cfg, str(tmp_path), device="cpu", workers=2)
    zs = ZipServer(params, cfg, str(tmp_path), device="cpu", L=3,
                   pool_sizes=POOLS)
    try:
        zs.decode_rows(torch.zeros((1, 1), dtype=torch.long),
                       zs.init_cache(1, 4), [0])
    finally:
        zs.close()


def _cli(arch, tmp_path, monkeypatch):
    import repro_torch.launch.serve as serve_mod

    def no_work(*a, **k):
        raise AssertionError("the CLI did work before refusing")

    monkeypatch.setattr(serve_mod, "init_params", no_work)
    serve_mod.main(["--device", "cpu", "--mode", "resident", "--arch", arch])


REFUSING = {
    "decode_rows": _decode_rows,
    "BatchServer": lambda arch, tmp, mp: BatchServer(None,
                                                     _refused_cfg(arch)),
    "KVPagePool": lambda arch, tmp, mp: KVPagePool(_refused_cfg(arch),
                                                   device="cpu"),
    "cli": _cli,
}


@pytest.mark.parametrize("arch", [SWITCH, VLM])
@pytest.mark.parametrize("entry", sorted(REFUSING))
def test_rows_entry_refuses(entry, arch, tmp_path, monkeypatch):
    """Continuous batching and the front end take neither an
    encoder-decoder nor a config fed embeddings: the reference has no
    correct path for them (its decode_rows drops the cross-attention, its
    BatchServer and CLI prefill tokens only)."""
    with pytest.raises(NotImplementedError, match="no reference path"):
        REFUSING[entry](arch, tmp_path, monkeypatch)


def test_zipserver_refuses_embeddings_input():
    """qwen2-vl-2b is served by the resident model only: the reference's
    ZipServer reads ``embed.tok``, which a config fed embeddings lacks,
    and rotates by the plain position.  switch is taken."""
    cfg = _refused_cfg(VLM)
    with pytest.raises(NotImplementedError, match="no reference path"):
        ZipServer(None, cfg, "/nonexistent", device="cpu")
    assert refusal(cfg, "model") is None
    sw = _refused_cfg(SWITCH)
    assert refusal(sw, "model") is None and refusal(sw, "zipserver") is None
    assert refusal(sw, "rows") is not None
    # tied embeddings tie the head to embed.tok: switch has one, a config
    # fed embeddings does not
    tied = dataclasses.replace(sw, tie_embeddings=True)
    assert refusal(tied, "model") is None
    assert refusal(dataclasses.replace(cfg, tie_embeddings=True),
                   "model") is not None
