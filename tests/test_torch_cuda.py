"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips without
a CUDA device (the build also needs ``nvcc``).  Run on a machine with an
H100 with ``python -m pytest -q tests/test_torch_cuda.py``.  This file
imports nothing of JAX, so it runs where JAX is not installed.

Tolerances: the splices are bit-exact; the ragged GEMM sums in f32 in
another order than the plain ``bmm``, and both round once to bf16, so
outputs agree to 2^-7 of the largest |output| (one or two bf16 ulps).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitfield
from repro_torch.kernels import _build, moe_gemm, ops, recovery, ref

pytestmark = pytest.mark.gpu
GEMM_REL_TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int16),
                       b.contiguous().view(torch.int16))


def test_splice_all_patterns(cuda):
    u = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    e, s = bitfield.decompose(u.view(torch.bfloat16))
    got = recovery.recover_bf16(e.to(cuda), s.to(cuda)).cpu()
    assert _same(got, u.view(torch.bfloat16))


@pytest.mark.parametrize("n,offset", [(2048 * 1408, 0), (1000003, 0),
                                      (4097, 1), (15, 0)])
def test_splice_any_length_and_alignment(cuda, n, offset):
    g = torch.Generator().manual_seed(n)
    e = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, generator=g)
    s = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, generator=g)
    got = recovery.recover_bf16(e.to(cuda)[offset:], s.to(cuda)[offset:])
    assert _same(got.cpu(), ref.recover_bf16_ref(e[offset:], s[offset:]))


def test_splice_admit_in_place(cuda):
    g = torch.Generator().manual_seed(0)
    cap, d, f, slot = 4, 64, 72, 2
    base = torch.randn((cap, d, f), generator=g).to(torch.bfloat16)
    w = torch.randn((d, f), generator=g).to(torch.bfloat16)
    e, s = bitfield.decompose(w)
    buf = base.to(cuda)
    ptr = buf.data_ptr()
    out = ops.slab_splice_set(buf, slot, e.to(cuda), s.to(cuda))
    assert out is buf and buf.data_ptr() == ptr
    assert _same(buf.cpu(), ref.splice_admit_ref(base, e, s, slot))
    with pytest.raises(ValueError):
        moe_gemm.slab_splice_admit(buf, e.to(cuda), s.to(cuda), cap)


@pytest.mark.parametrize("d,f,ts", [
    (2048, 1408, [2, 0, 0, 3, 1, 7, 5, 5]),     # main path, vector loads
    (1408, 2048, [1, 2, 3, 4]),
    (24, 40, [2, 0, 1]),                        # d, f under one block
    (64, 72, [1, 0]),                           # ragged f edge
])
def test_slab_gemm_vs_plain(cuda, d, f, ts):
    g = torch.Generator().manual_seed(d + f)
    cap = max(ts) + 1
    ts = np.asarray(ts, np.int32)
    x = torch.randn((ts.size * 8, d), generator=g).to(torch.bfloat16)
    x[8:16] = 0                                 # a singleton group
    x[9] = torch.randn((d,), generator=g).to(torch.bfloat16)
    buf = (torch.randn((cap, d, f), generator=g) * 0.05).to(torch.bfloat16)
    got = ops.slab_gemm(x.to(cuda), buf.to(cuda), ts).float().cpu()
    want = ref.slab_gemm_ref(x, buf, ts).float()
    err = (got - want).abs().max().item()
    assert err <= GEMM_REL_TOL * want.abs().max().item()
    assert torch.all(got[10:16] == 0)           # zero pad rows stay zero


def test_slab_gemm_rejects_bad_slots(cuda):
    x = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    buf = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        moe_gemm.slab_ragged_gemm(x, buf, np.asarray([2], np.int32))
    with pytest.raises(ValueError):
        moe_gemm.slab_ragged_gemm(x, buf, np.asarray([0, 1], np.int32))


def test_slab_gemm_rejects_unaligned_weights(cuda):
    """The kernel reads weights in 16-byte loads only: f % 8 != 0 or a
    misaligned buffer raises before launch."""
    x = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    ts = np.zeros(1, np.int32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.slab_ragged_gemm(
            x, torch.zeros((1, 16, 36), dtype=torch.bfloat16, device=cuda), ts)
    flat = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.slab_ragged_gemm(x, flat[1:].view(1, 16, 16), ts)
    assert _build.LAUNCHES["slab_gemm"] == 0


def test_zipserver_on_card_launches_kernels(cuda, tmp_path):
    """Smoke-size ZipServer on the card: all three kernels launch, and the
    logits match the resident model on the card within 2% of the largest
    |logit| (bf16 sums in other orders), the tolerance of the CPU parity
    tests."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2}, device=cuda)
    try:
        B = 2
        caches, rcache = zs.init_cache(B, 4), init_cache(cfg, B, 4, cuda)
        tok = torch.zeros((B, 1), dtype=torch.long, device=cuda)
        _build.reset_launches()
        for i in range(4):
            lg, caches = zs.decode_step(tok, caches, i)
            rl, rcache = decode_step(params, cfg, tok, rcache, i)
            err = (lg.float() - rl.float()).abs().max().item()
            assert err <= 0.02 * rl.float().abs().max().item(), (i, err)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        assert all(n > 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES
    finally:
        zs.close()
