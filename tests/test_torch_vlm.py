"""M-RoPE over input embeddings in the port (qwen2-vl-2b at its smoke
widths: head_dim 32, so ``apply_mrope`` rescales its frequency sections)
against the JAX package.

The M-RoPE positions lay out one image grid followed by text
(:func:`mrope_grid`): the image's tokens share a temporal position and
walk its rows and columns, the text's advance all three channels
together.  The three channels therefore differ; with equal channels
M-RoPE is plain RoPE and a test of it would prove nothing.

Tolerances: ``apply_mrope`` alone in f32 within 1e-5 of the largest
|output| (the two packages' cos/sin differ in the last bits); the model
in bf16 within ``MAX_REL`` (2%) of the largest |logit| at worst and
``MEAN_REL`` (0.5%) on average, in f32 within 1e-4; the port's own
``prefill(S-1)`` + ``decode_step`` ≡ ``forward(S)`` within 1e-4 in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
from repro.configs import ShapeConfig as RefShape
from repro.models import decode_step as ref_decode_step
from repro.models.inputs import make_batch as ref_make_batch
from repro.models.layers import apply_mrope as ref_apply_mrope
from repro.models.layers import apply_rope as ref_apply_rope
from repro.models.model import forward as ref_forward
from repro.serving.kv_cache import grow_cache as ref_grow_cache
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.inputs import make_batch
from repro_torch.models.layers import apply_mrope
from repro_torch.serving.kv_cache import grow_cache
from test_torch_encdec import _assert_close
from test_torch_models import both_params

VLM = "qwen2-vl-2b"
B, S = 2, 12


def mrope_grid(batch: int, seq: int, grid=(2, 3)) -> np.ndarray:
    """[3, batch, seq] int32 M-RoPE positions: a ``grid[0] x grid[1]``
    image (temporal 0, its row, its column) followed by text starting one
    past the image's largest position, on all three channels."""
    gh, gw = grid
    n_img = gh * gw
    pos = np.zeros((3, seq), np.int32)
    idx = np.arange(n_img)
    pos[1, :n_img], pos[2, :n_img] = idx // gw, idx % gw
    pos[:, n_img:] = max(gh, gw) + np.arange(seq - n_img)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch,
                                                                seq)))


def _params(dtype="bfloat16"):
    kw = dict(dtype="float32") if dtype == "float32" else {}
    return both_params(n_layers=4, arch=VLM, **kw)


def _batches(jcfg, cfg, kind="prefill"):
    jb = ref_make_batch(jcfg, RefShape("t", S, B, kind), kind, seed=1)
    tb = make_batch(cfg, ShapeConfig("t", S, B, kind), kind, seed=1,
                    device="cpu")
    return jb, tb


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_apply_mrope_matches_reference(head_dim):
    """128 takes the published sections (16, 24, 24); 32 and 64 rescale
    them.  The three channels differ, and the result is not plain RoPE."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((B, S, 4, head_dim)).astype(np.float32)
    pos3 = mrope_grid(B, S)
    want = np.asarray(ref_apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                      1e6))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                      1e6).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    plain = np.asarray(ref_apply_rope(jnp.asarray(x), jnp.asarray(pos3[0]),
                                      1e6))
    # the height and width sections are the low frequencies: the grid
    # moves them a little, far past the two packages' noise
    assert np.abs(plain - want).max() > 1e-2 * scale


def test_mrope_grid_channels_differ():
    pos3 = mrope_grid(B, S)
    assert not np.array_equal(pos3[0], pos3[1])
    assert not np.array_equal(pos3[1], pos3[2])
    assert (pos3[:, :, 6:] == pos3[0, :, 6:]).all()      # text: equal


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resident_matches_reference(dtype):
    """``forward`` of embeddings with the grid's M-RoPE positions, then
    ``prefill`` of the first S-1 and ``decode_step`` of the last one with
    its own three channels, in both packages."""
    jcfg, jparams, cfg, params = _params(dtype)
    jb, tb = _batches(jcfg, cfg)
    pos3 = mrope_grid(B, S)
    jb["mrope_positions"] = jnp.asarray(pos3)
    tb["mrope_positions"] = torch.from_numpy(pos3)
    jl, _, _ = ref_forward(jparams, jcfg, jb, unroll=True)
    tl, _, _ = forward(params, cfg, embeds=tb["embeds"],
                       mrope_positions=tb["mrope_positions"])
    _assert_close(tl, jl, dtype, "forward")
    jp = {"embeds": jb["embeds"][:, :S - 1],
          "mrope_positions": jb["mrope_positions"][:, :, :S - 1]}
    jl, jc = ref_forward(jparams, jcfg, jp, mode="prefill", unroll=True)[:2]
    tl, tc = prefill(params, cfg, embeds=tb["embeds"][:, :S - 1],
                     mrope_positions=tb["mrope_positions"][:, :, :S - 1])
    _assert_close(tl, jl, dtype, "prefill")
    jc = ref_grow_cache(jcfg, jc, B, S)
    tc = grow_cache(cfg, tc, B, S)
    jl, _ = ref_decode_step(
        jparams, jcfg, {"embeds": jb["embeds"][:, S - 1:],
                        "mrope_positions": jb["mrope_positions"][:, :, S - 1:]},
        jc, jnp.int32(S - 1), unroll=True)
    tl, _ = decode_step(params, cfg, None, tc, S - 1,
                        embeds=tb["embeds"][:, S - 1:],
                        mrope_positions=tb["mrope_positions"][:, :, S - 1:])
    _assert_close(tl, jl, dtype, "decode_step")


def test_prefill_decode_matches_forward_f32():
    """The port alone: ``prefill(S-1)`` + ``decode_step`` ≡ ``forward(S)``
    within 1e-4 in f32, on the grid's positions."""
    _, _, cfg, params = _params("float32")
    tb = make_batch(cfg, ShapeConfig("t", S, B, "prefill"), "prefill",
                    seed=1, device="cpu")
    pos3 = torch.from_numpy(mrope_grid(B, S))
    want, _, _ = forward(params, cfg, embeds=tb["embeds"],
                         mrope_positions=pos3)
    _, caches = prefill(params, cfg, embeds=tb["embeds"][:, :S - 1],
                        mrope_positions=pos3[:, :, :S - 1])
    caches = grow_cache(cfg, caches, B, S)
    got, _ = decode_step(params, cfg, None, caches, S - 1,
                         embeds=tb["embeds"][:, S - 1:],
                         mrope_positions=pos3[:, :, S - 1:])
    _assert_close(got[:, 0], want[:, -1].numpy(), "float32", VLM)


def test_gqa_decode_rows_mrope_matches_reference():
    """One attention layer's per-row decode, each row at its own position
    with its own three channels, in f32."""
    jcfg, jparams, cfg, params = _params("float32")
    jp = {k: v[0] for k, v in
          jparams["decoder"]["stack"]["sub_0"]["attn"].items()}
    tp = params["layers"][0]["attn"]
    rng = np.random.default_rng(5)
    T = 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((B, T, cfg.n_kv_heads, cfg.head_dim)
                            ).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    positions = np.asarray([3, 6], np.int32)
    pos3 = np.stack([mrope_grid(1, T)[:, 0, p] for p in positions], 1)
    pos3 = np.ascontiguousarray(pos3[:, :, None])             # [3, B, 1]
    jy, jc = ref_attn.gqa_decode_rows(
        jp, jnp.asarray(x), jcfg, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(positions), mrope_positions=jnp.asarray(pos3))
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    ty, tc = attn_lib.gqa_decode_rows(
        tp, torch.from_numpy(x), cfg, tc, torch.from_numpy(positions).long(),
        mrope_positions=torch.from_numpy(pos3))
    _assert_close(ty, jy, "float32", "y")
    _assert_close(tc["k"], jc["k"], "float32", "k")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_reference(kind):
    """Embeddings, M-RoPE positions and labels bit-equal to the JAX
    package's draw."""
    jcfg, _, cfg, _ = _params()
    jb, tb = _batches(jcfg, cfg, kind)
    assert jb.keys() == tb.keys() and "tokens" not in tb
    for name, v in jb.items():
        want = np.asarray(v)
        got = tb[name]
        if v.dtype == jnp.bfloat16:
            want = want.view(np.uint16)
            got = got.view(torch.int16).numpy().view(np.uint16)
        else:
            got = got.numpy()
        assert got.shape == want.shape and np.array_equal(got, want), name
