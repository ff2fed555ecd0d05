"""Building blocks of the references: products, norms, rotary positions,
the causal mask, MLPs and MoE.  Activations are float32 tensors of shape [B, S, ...]."""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale per slice along `dim`
    (the reduction axis of the product it feeds), back in float32."""
    t = t.float()
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x [..., K] @ w [K, M] in float32; ``prec="fp8"`` rounds x per row and
    w per column to float8 first."""
    xf, wf = x.float(), w.float()
    if prec == "fp8":
        xf, wf = q8(xf, -1), q8(wf, 0)
    elif prec != "f32":
        raise ValueError(prec)
    return xf @ wf


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, scale, eps=1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def yarn_mscale(scale, m):
    """YaRN's attention factor at context `scale` (DeepSeek-V2's
    ``yarn_get_mscale``): 1 at a scale of 1 or less."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_inv_freq(D, theta, rs, device):
    """Inverse frequencies [D/2] of D rope dims; under a YaRN `rs`
    (``rope_scaling``) the low frequencies are divided by its factor along
    the ramp between the beta_fast and beta_slow rotations, as DeepSeek-V2
    defines it. No `rs`, or a factor of 1, gives plain RoPE."""
    extra = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=device) / D))
    if not rs or rs["factor"] <= 1:
        return extra
    if rs["type"] != "yarn":
        raise NotImplementedError(f"rope_scaling {rs['type']!r}")

    def dim_of(rotations):
        return D * math.log(rs["original_max_position_embeddings"]
                            / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    lo = max(math.floor(dim_of(rs["beta_fast"])), 0)
    hi = min(math.ceil(dim_of(rs["beta_slow"])), D - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(D // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    inter = 1.0 / (rs["factor"] * theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))
    return inter * ramp + extra * (1.0 - ramp)


def softmax_factor(rs):
    """What YaRN multiplies the 1/sqrt(head) softmax scale by."""
    if not rs or not rs.get("mscale_all_dim"):
        return 1.0
    return yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def rotate(x, positions, theta, rs=None):
    """RoPE on x [B, S, H, D] at positions [S]: the first and second halves
    of the last dim are the two coordinates of each rotated pair; `rs` is
    the configuration's ``rope_scaling``."""
    D = x.shape[-1]
    inv = rope_inv_freq(D, theta, rs, x.device)
    ang = positions.float()[:, None] * inv                 # [S, D/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    if rs and rs["factor"] > 1:
        m = yarn_mscale(rs["factor"], rs.get("mscale", 1)) \
            / yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0) or 1)
        cos, sin = cos * m, sin * m
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal(S, device):
    return torch.arange(S, device=device)[None, :] <= \
        torch.arange(S, device=device)[:, None]            # [S, S]


def silu(x):
    return x * torch.sigmoid(x)


def mlp(p, x, act, prec, w=None):
    """A dense swiglu MLP (w_gate, w_up, w_down) on x [N, d]; `w` picks one
    expert's weights out of [E, ...] stacks."""
    def W(name):
        t = p[name]
        return t if w is None else t[w]
    if act != "swiglu":
        raise NotImplementedError(f"activation {act!r}")
    h = silu(mm(x, W("w_gate"), prec)) * mm(x, W("w_up"), prec)
    return mm(h, W("w_down"), prec)


def moe(p, x, hp, prec):
    """Routed experts plus shared ones on x [N, d]: softmax router in
    float32 over all experts, top-k gates (renormalised when the config
    says so), each token through its k experts."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_p, top_i = torch.topk(probs, hp.top_k, dim=-1)
    if hp.router_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x, dtype=torch.float32)
    for e in torch.unique(top_i).tolist():
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        out = mlp(p, x[rows], hp.act, prec, w=e)
        y.index_add_(0, rows, top_p[rows, slot, None] * out)
    if "shared" in p:
        y = y + mlp(p["shared"], x, hp.act, prec)
    return y


def is_moe_layer(hp, i: int) -> bool:
    return hp.n_experts > 0 and i >= hp.first_dense \
        and i % hp.moe_every == hp.moe_offset


def ffn(p, x, hp, i, prec):
    """Layer i's FFN on x [B, S, d]."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    y = moe(p, flat, hp, prec) if is_moe_layer(hp, i) \
        else mlp(p, flat, hp.act, prec)
    return y.reshape(B, S, d)
