"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: ZipMoE's expert cache/scheduler is inapplicable (no conditional
expert activation); the lossless bit-plane codec still applies to parameters
(`zipmoe="dense"`).  See DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                # attn-free, no MLP: mamba2 blocks only
    vocab_size=50280,
    attn="none",
    pos="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,        # d_inner=2048 -> 32 ssm heads
    ssm_groups=1,
    ssm_conv=4,
    norm="rmsnorm",
    zipmoe="dense",
)
