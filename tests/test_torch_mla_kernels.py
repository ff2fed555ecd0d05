"""MLA decode's two kernels (``kernels/mla_decode.py``,
``csrc/mla_decode.cu``) and their plain versions (``kernels/ref.py``).

On the CPU: the plain versions, which ``mla_decode`` / ``mla_decode_rows``
take for CPU tensors, are bit for bit the composition the port ran before
the kernels (kept below as ``_old_*``, verbatim), absorbed and not, at one
position and at a position per row; the wrappers refuse a wrong device,
dtype, shape or width before any launch; the reckoned reduction lanes; the
rope table the launch passes; the plain write refusing a position past the
cache; no kernel module importing a model module.

On the card (``gpu``; skipped without a CUDA device; run with ``python -m
pytest -q tests/test_torch_mla_kernels.py`` on a machine with an H100): the
kernels against the plain versions run on the card at both benchmark
cells' attention shapes (B 16; 16 and 32 heads; latent 512, rope 64, nope
and v 128; T_pad 1,536; positions 0 and T_pad - 1 among them): the written
latent bit-equal, the rope key and query within one bf16 ulp, the output
within 2^-7 of the largest |output| (both sum in f32 in other orders and
round once to bf16, as ``tests/test_torch_cuda.py::test_mla_layer_on_card``
states); a row alone, in the batch and under a larger T_pad bit-equal;
``mla_decode_rows`` free of synchronising calls; one launch a kernel a
call; a position outside the cache stopping either kernel with a trap (in
a child process, since a trap leaves the CUDA context unusable).  This
file imports nothing of JAX.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _build, mla_decode, ref
from repro_torch.models import attention as attn_lib
from repro_torch.kernels.ref import (apply_rope, rms_norm_headwise,
                                     rope_freqs, where_mask)
from repro_torch.models.attention import _mla_out, _mla_scale, _mla_wkv_b

OUT_REL_TOL = 2.0 ** -7
# MLA widths at which head_dim, qk_nope + qk_rope and v_head_dim all differ
ODD = dict(qk_nope_dim=24, qk_rope_dim=8, v_head_dim=40, kv_lora_rank=48)
# the benchmark cells' attention widths, at a small d_model
CELL = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
            kv_lora_rank=512, d_model=256)


# ---------------------------------------------------------------------------
# the composition before the kernels, verbatim
# ---------------------------------------------------------------------------
def _old_mla_q(p, x, cfg):
    B, S, _ = x.shape
    qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm_headwise(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, qk_head)
    return q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)


def _old_mla_kv_latent(p, x, cfg, positions):
    ckv, k_rope = (x @ p["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rms_norm_headwise(p["kv_norm"], ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _old_mla_decode_attend(p, x, cfg, q_nope, q_rope, ckv, k_rope, mask,
                           absorb):
    scale = _mla_scale(cfg)
    qr, kr, cf = q_rope.float(), k_rope.float(), ckv.float()
    if absorb:
        wkv_b = _mla_wkv_b(p, cfg)
        w_k = wkv_b[:, :, :cfg.qk_nope_dim]
        q_c = torch.einsum("bshd,chd->bshc", q_nope.float(), w_k)
        w_v = wkv_b[:, :, cfg.qk_nope_dim:]
        sc = (torch.einsum("bshc,btc->bhst", q_c, cf)
              + torch.einsum("bshd,btd->bhst", qr, kr)) * scale
        attn = torch.softmax(where_mask(sc, mask), dim=-1)
        o_c = torch.einsum("bhst,btc->bshc", attn, cf)
        return _mla_out(p, x, cfg, torch.einsum("bshc,chd->bshd", o_c, w_v))
    kv = torch.einsum("btc,chd->bthd", cf, _mla_wkv_b(p, cfg))
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    sc = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope)
          + torch.einsum("bshd,btd->bhst", qr, kr)) * scale
    attn = torch.softmax(where_mask(sc, mask), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", attn, v)
    return _mla_out(p, x, cfg, out)


def _old_mla_decode(p, x, cfg, cache, pos, *, absorb=True):
    B = x.shape[0]
    T = cache["ckv"].shape[1]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q_nope, q_rope = _old_mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    ckv_new, k_rope_new = _old_mla_kv_latent(p, x, cfg, posv)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["k_rope"][:, pos] = k_rope_new[:, 0]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, None, :]
    y = _old_mla_decode_attend(p, x, cfg, q_nope, q_rope, cache["ckv"],
                               cache["k_rope"], mask, absorb)
    return y, cache


def _old_mla_decode_rows(p, x, cfg, cache, positions, *, absorb=True):
    B = x.shape[0]
    T = cache["ckv"].shape[1]
    posv = positions[:, None]
    q_nope, q_rope = _old_mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    ckv_new, k_rope_new = _old_mla_kv_latent(p, x, cfg, posv)
    rows = torch.arange(B, device=x.device)
    cache["ckv"][rows, positions] = ckv_new[:, 0]
    cache["k_rope"][rows, positions] = k_rope_new[:, 0]
    mask = (torch.arange(T, device=x.device)[None, :]
            <= positions[:, None])[:, None, None]
    y = _old_mla_decode_attend(p, x, cfg, q_nope, q_rope, cache["ckv"],
                               cache["k_rope"], mask, absorb)
    return y, cache


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _layer(arch, widths, dtype="bfloat16", device="cpu", seed=0):
    cfg = get_smoke_config(arch, n_layers=1, dtype=dtype, **widths)
    g = torch.Generator(device=device).manual_seed(seed)
    return cfg, attn_lib.init_attn(g, cfg, device), g


def _inputs(cfg, g, B, T, device="cpu"):
    dt = getattr(torch, cfg.dtype)
    x = torch.randn((B, 1, cfg.d_model), generator=g, device=device).to(dt)
    cache = {"ckv": torch.randn((B, T, cfg.kv_lora_rank), generator=g,
                                device=device).to(dt),
             "k_rope": torch.randn((B, T, cfg.qk_rope_dim), generator=g,
                                   device=device).to(dt)}
    return x, cache


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("widths", [ODD, CELL], ids=["odd", "cell"])
@pytest.mark.parametrize("arch", ["deepseekv2-lite", "deepseek-v2-236b"])
@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "plain"])
@pytest.mark.parametrize("rows", [True, False],
                         ids=["decode_rows", "decode"])
def test_plain_twin_is_the_old_composition(rows, absorb, arch, widths,
                                           dtype):
    """On the CPU, ``mla_decode`` / ``mla_decode_rows`` (now through
    ``ops.mla_rope_write`` / ``ops.mla_absorbed_attend`` and their plain
    versions) give the old composition's output and cache bit for bit."""
    cfg, p, g = _layer(arch, widths, dtype)
    B, T = 4, 24
    x, cache = _inputs(cfg, g, B, T)
    old_cache = {k: v.clone() for k, v in cache.items()}
    if rows:
        positions = torch.tensor([3, 23, 0, 11])
        y, got = attn_lib.mla_decode_rows(p, x, cfg, cache, positions,
                                          absorb=absorb)
        want, want_c = _old_mla_decode_rows(p, x, cfg, old_cache, positions,
                                            absorb=absorb)
    else:
        y, got = attn_lib.mla_decode(p, x, cfg, cache, 13, absorb=absorb)
        want, want_c = _old_mla_decode(p, x, cfg, old_cache, 13,
                                       absorb=absorb)
    assert got is cache
    assert y.dtype == want.dtype and y.shape == want.shape
    assert torch.equal(_bits(y), _bits(want))
    for name in cache:
        assert torch.equal(_bits(cache[name]), _bits(want_c[name])), name


def _wrapper_args(B=2, T=8, H=2, C=16, Dr=8, Dn=16, Dv=16,
                  dtype=torch.bfloat16):
    """Valid CPU arguments of both wrappers."""
    z = torch.zeros
    common = dict(q=z((B, 1, H * (Dn + Dr)), dtype=dtype),
                  positions=z(B, dtype=torch.int64),
                  ckv=z((B, T, C), dtype=dtype),
                  k_rope=z((B, T, Dr), dtype=dtype))
    write = dict(common, kv=z((B, 1, C + Dr), dtype=dtype),
                 kv_norm=z(C, dtype=torch.float32))
    attend = dict(common, q_rope=z((B, 1, H, Dr), dtype=dtype),
                  wkv_b=z((C, H * (Dn + Dv)), dtype=dtype))
    return write, attend, dict(n_heads=H, v_head_dim=Dv)


def _call(kernel, **changes):
    """Call wrapper `kernel` on valid CPU arguments with `changes`."""
    write, attend, kw = _wrapper_args(
        **{k: changes.pop(k) for k in ("C", "Dr", "Dn", "Dv")
           if k in changes})
    if kernel == "write":
        args = dict(write, **changes)
        return mla_decode.rope_write(
            args["q"], args["kv"], args["kv_norm"], args["positions"],
            args["ckv"], args["k_rope"], n_heads=kw["n_heads"],
            rope_theta=1e4)
    args = dict(attend, **changes)
    return mla_decode.absorbed_attend(
        args["q"], args["q_rope"], args["wkv_b"], args["ckv"],
        args["k_rope"], args["positions"], n_heads=kw["n_heads"],
        v_head_dim=kw["v_head_dim"], scale=0.1)


REFUSALS = [
    # (kernel, changes, error, message)
    ("write", {}, ValueError, "CUDA"),
    ("attend", {}, ValueError, "CUDA"),
    ("write", {"q": torch.zeros((2, 1, 48), dtype=torch.float16)},
     TypeError, "q: expected"),
    ("attend", {"ckv": torch.zeros((2, 8, 16), dtype=torch.float32)},
     TypeError, "ckv: expected"),
    ("write", {"positions": torch.zeros(2, dtype=torch.int32)}, TypeError,
     "positions: expected"),
    ("write", {"kv_norm": torch.zeros(16, dtype=torch.bfloat16)}, TypeError,
     "kv_norm: expected"),
    ("write", {"kv": torch.zeros((2, 1, 23), dtype=torch.bfloat16)},
     ValueError, "kv: expected shape"),
    ("attend", {"positions": torch.zeros(3, dtype=torch.int64)}, ValueError,
     "positions: expected shape"),
    ("attend", {"wkv_b": torch.zeros((16, 63), dtype=torch.bfloat16)},
     ValueError, "wkv_b: expected shape"),
    ("write", {"C": 12}, ValueError, "latent width = 12"),
    ("attend", {"Dr": 4}, ValueError, "rope width = 4"),
    ("attend", {"Dn": 20}, ValueError, "nope width = 20"),
    ("attend", {"Dv": 36}, ValueError, "value width = 36"),
    ("attend", {"C": 1024}, ValueError, "at most 512"),
    ("attend", {"Dr": 256}, ValueError, "at most 128"),
]


@pytest.mark.parametrize("kernel,changes,err,msg", REFUSALS,
                         ids=[f"{k}-{i}" for i, (k, *_) in
                              enumerate(REFUSALS)])
def test_wrapper_refuses(kernel, changes, err, msg):
    """The CUDA wrappers check dtypes, shapes and widths before the
    device, and take CUDA tensors only: every refusal here raises on the
    CPU before any launch."""
    _build.reset_launches()
    with pytest.raises(err, match=msg):
        _call(kernel, **changes)
    assert _build.LAUNCHES["mla_rope_write"] == 0
    assert _build.LAUNCHES["mla_absorbed_attend"] == 0


@pytest.mark.parametrize("rows,n,want", [
    (16, 512, (32, True)), (17, 512, (32, True)), (8, 512, (64, True)),
    (4, 512, (128, True)), (1, 512, (128, True)), (16, 48, (32, False)),
    (1, 48, (32, False)), (16, 2048, (32, True)), (1, 4096, (512, True))])
def test_torch_reduce_lanes(rows, n, want):
    """The lanes of PyTorch's CUDA row-wise reduction (Reduce.cuh's
    ``setReduceConfig``): a warp of 32 once a batch has 16 rows, wider
    blocks for fewer rows, vectors of four from a row of 128 on."""
    assert mla_decode.torch_reduce_lanes(rows, n) == want


def test_torch_reduce_lanes_refuses_a_split_row():
    with pytest.raises(ValueError, match="splits each row"):
        mla_decode.torch_reduce_lanes(16, 8192)


@pytest.mark.parametrize("dr,theta", [(64, 10000.0), (64, 1e6), (8, 10000.0),
                                      (128, 50000.0)])
def test_freq_table_is_the_plain_rope_table(dr, theta):
    """The table the rope kernel's launch carries is the plain rotation's
    f32 frequencies bit for bit, made once per (width, theta)."""
    got = mla_decode.freq_table(dr, theta)
    assert got.dtype == np.float32 and got.shape == (dr // 2,)
    assert got.flags.c_contiguous
    assert np.array_equal(got.view(np.int32),
                          rope_freqs(dr, theta).astype(np.float32)
                          .view(np.int32))
    assert mla_decode.freq_table(dr, theta) is got


@pytest.mark.parametrize("pos", [8, 9])
def test_plain_write_refuses_a_position_past_the_cache(pos):
    """On the CPU the plain write fails for a position at or past T, as
    the kernel traps on the card."""
    write, _, kw = _wrapper_args()
    write["positions"] = torch.tensor([1, pos])
    with pytest.raises(IndexError):
        ref.mla_rope_write_ref(
            write["q"], write["kv"], write["kv_norm"], write["positions"],
            write["ckv"], write["k_rope"], n_heads=kw["n_heads"],
            rope_theta=1e4)


KERNEL_MODULES = sorted(
    f.stem for f in (Path(__file__).resolve().parents[1] / "src"
                     / "repro_torch" / "kernels").glob("*.py"))


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernels_import_nothing_of_the_models(module):
    """``kernels/`` sits below ``models/``: no kernel module, wrapper or
    plain version imports a model module, at its top or inside a
    function (the plain MLA decode's rotary embedding, norm and mask live
    in ``kernels/ref.py``, and the models import them from there)."""
    import ast
    path = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "kernels" / f"{module}.py")
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
    assert not [n for n in names if n.startswith("repro_torch.models")]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cell_operands(cuda, H, B=16, T=1536, dtype=torch.bfloat16, seed=0):
    """Random operands at a benchmark cell's attention widths: the two
    projections' outputs, ``kv_norm``, ``wkv_b``, a latent cache and row
    positions with 0 and T - 1 among them."""
    C, Dr, Dn, Dv = 512, 64, 128, 128
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * std).to(dtype)

    pos = torch.randint(1, T - 1, (B,), generator=g, device=cuda)
    pos[0], pos[1] = T - 1, 0
    return dict(
        q=rnd((B, 1, H * (Dn + Dr))), kv=rnd((B, 1, C + Dr)),
        kv_norm=torch.rand(C, generator=g, device=cuda) + 0.5,
        wkv_b=rnd((C, H * (Dn + Dv)), 0.05), ckv=rnd((B, T, C)),
        k_rope=rnd((B, T, Dr)), positions=pos, H=H, Dv=Dv,
        scale=float(np.float32(1.0) / np.sqrt(np.float32(Dn + Dr))))


def _ulps(a, b):
    """Largest distance in ulps of the dtype (as bit patterns of
    same-signed values)."""
    ai, bi = _bits(a).int(), _bits(b).int()
    return int((ai - bi).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("H", [16, 32])
def test_kernels_match_the_plain_versions_at_the_cells_shapes(cuda, H,
                                                              dtype):
    """Both kernels against their plain versions on the card at the
    cells' shapes: the latent cache bit-equal after the write, the rope
    key and query within one ulp, the output within 2^-7 (bf16) or 1e-5
    (f32) of the largest |output|."""
    o = _cell_operands(cuda, H, dtype=dtype)
    caches = {}
    for side in ("plain", "kernel"):
        caches[side] = {"ckv": o["ckv"].clone(), "k_rope": o["k_rope"].clone()}
    c0, c1 = caches["plain"], caches["kernel"]
    qr0 = ref.mla_rope_write_ref(o["q"], o["kv"], o["kv_norm"],
                                 o["positions"], c0["ckv"], c0["k_rope"],
                                 n_heads=H, rope_theta=1e4)
    qr1 = mla_decode.rope_write(o["q"], o["kv"], o["kv_norm"],
                                o["positions"], c1["ckv"], c1["k_rope"],
                                n_heads=H, rope_theta=1e4)
    torch.cuda.synchronize()
    assert torch.equal(_bits(c1["ckv"]), _bits(c0["ckv"]))
    assert _ulps(c1["k_rope"], c0["k_rope"]) <= 1
    assert _ulps(qr1, qr0) <= 1
    y0 = ref.mla_absorbed_attend_ref(
        o["q"], qr0, o["wkv_b"], c0["ckv"], c0["k_rope"], o["positions"],
        n_heads=H, v_head_dim=o["Dv"], scale=o["scale"])
    y1 = mla_decode.absorbed_attend(
        o["q"], qr0, o["wkv_b"], c0["ckv"], c0["k_rope"], o["positions"],
        n_heads=H, v_head_dim=o["Dv"], scale=o["scale"])
    assert y1.shape == y0.shape == (16, 1, H * o["Dv"])
    assert y1.dtype == dtype
    y0, y1 = y0.float(), y1.float()
    rel = OUT_REL_TOL if dtype == torch.bfloat16 else 1e-5
    assert bool(torch.isfinite(y1).all())
    assert (y1 - y0).abs().max() <= rel * y0.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("H", [16, 32])
def test_attend_row_alone_in_batch_and_padded(cuda, H):
    """Row 0's output alone (B 1, T = its position + 1), in the batch of
    16 (T_pad 1,536) and in the batch under T_pad 2,048 (garbage past
    every row's position) is bit for bit the same: the kernel's sums
    depend on the widths and positions alone."""
    o = _cell_operands(cuda, H)
    T = o["ckv"].shape[1]
    p0 = int(o["positions"][2])

    q_rope = o["q"].reshape(16, 1, H, 192)[..., 128:].contiguous()

    def run(rows, ckv, k_rope):
        return mla_decode.absorbed_attend(
            o["q"][rows], q_rope[rows], o["wkv_b"], ckv, k_rope,
            o["positions"][rows], n_heads=H, v_head_dim=o["Dv"],
            scale=o["scale"])

    batch = run(slice(0, 16), o["ckv"], o["k_rope"])
    pad = 2048 - T
    junk = torch.full((16, pad, 512), 7.0, device=cuda, dtype=torch.bfloat16)
    padded = run(slice(0, 16), torch.cat([o["ckv"], junk], 1),
                 torch.cat([o["k_rope"], junk[..., :64]], 1))
    alone = run(slice(2, 3), o["ckv"][2:3, :p0 + 1].contiguous(),
                o["k_rope"][2:3, :p0 + 1].contiguous())
    assert torch.equal(_bits(batch), _bits(padded))
    assert torch.equal(_bits(batch[2:3]), _bits(alone))


def _full_attn(cuda, arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    g = torch.Generator(device=cuda).manual_seed(1)
    return cfg, attn_lib.init_attn(g, cfg, cuda), g


@pytest.mark.gpu
def test_decode_rows_makes_no_synchronising_call(cuda):
    """``mla_decode_rows`` at deepseekv2-lite's widths under
    ``torch.cuda.set_sync_debug_mode("error")``: no call synchronises
    (the rope table goes by value among the launch's arguments; it is
    dropped first so its first making is checked too)."""
    cfg, p, g = _full_attn(cuda, "deepseekv2-lite")
    x, cache = _inputs(cfg, g, 16, 64, cuda)
    positions = torch.arange(16, device=cuda) * 3
    attn_lib.mla_decode_rows(p, x, cfg, cache, positions)   # build, warm
    torch.cuda.synchronize()
    mla_decode.freq_table.cache_clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = attn_lib.mla_decode_rows(p, x, cfg, cache, positions)
        y2, _ = attn_lib.mla_decode_rows(p, x, cfg, cache, positions)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y2))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseekv2-lite", "kanana-2-30b-a3b",
                                  "deepseek-v2-236b"])
def test_one_launch_a_kernel_a_call(cuda, arch):
    """Each MLA decode call launches ``mla_rope_write`` once and, absorbed,
    ``mla_absorbed_attend`` once: the count per window step is the number
    of MLA layers."""
    cfg, p, g = _full_attn(cuda, arch)
    x, cache = _inputs(cfg, g, 4, 32, cuda)
    positions = torch.tensor([0, 5, 31, 17], device=cuda)
    _build.reset_launches()
    attn_lib.mla_decode_rows(p, x, cfg, cache, positions)
    assert (_build.LAUNCHES["mla_rope_write"],
            _build.LAUNCHES["mla_absorbed_attend"]) == (1, 1)
    attn_lib.mla_decode(p, x, cfg, cache, 7)
    assert (_build.LAUNCHES["mla_rope_write"],
            _build.LAUNCHES["mla_absorbed_attend"]) == (2, 2)
    attn_lib.mla_decode(p, x, cfg, cache, 7, absorb=False)
    assert (_build.LAUNCHES["mla_rope_write"],
            _build.LAUNCHES["mla_absorbed_attend"]) == (3, 2)


REPO = Path(__file__).resolve().parents[1]
_TRAP = """
import sys
import torch
from repro_torch.kernels import mla_decode
kernel, pos = sys.argv[1], int(sys.argv[2])
dev, dt = torch.device("cuda"), torch.bfloat16
B, T, H, C, Dr, Dn, Dv = 2, 8, 2, 16, 8, 16, 16
z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
q, ckv, k_rope = z(B, 1, H * (Dn + Dr)), z(B, T, C), z(B, T, Dr)
positions = torch.tensor([1, pos], device=dev)
if kernel == "write":
    mla_decode.rope_write(q, z(B, 1, C + Dr),
                          torch.ones(C, device=dev), positions, ckv, k_rope,
                          n_heads=H, rope_theta=1e4)
else:
    mla_decode.absorbed_attend(q, z(B, 1, H, Dr), z(C, H * (Dn + Dv)), ckv,
                               k_rope, positions, n_heads=H, v_head_dim=Dv,
                               scale=0.1)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", e)
else:
    print("ran to its end")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("pos", [-1, 8], ids=["negative", "past_T"])
@pytest.mark.parametrize("kernel", ["write", "attend"])
def test_a_position_outside_the_cache_traps(cuda, kernel, pos):
    """Either kernel, given a row position outside ``[0, T)``, stops with a
    device-side trap that the next synchronise raises, where the plain
    code's write raises or lands elsewhere: no silent answer.  In a child
    process, since a trap leaves the CUDA context unusable."""
    _build.library()                       # the child finds the build
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", _TRAP, kernel, str(pos)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert "trapped:" in run.stdout, (run.stdout, run.stderr)
