"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Period-8 super-block: local index 3 is attention, the rest Mamba; MoE MLP on
every other layer (odd local indices).  Jamba uses Mamba-1 internally; we use
the SSD (Mamba-2) form with its small state (n=16) — noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,          # GQA on the attention layers
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    d_expert=14336,
    moe_every=2,
    moe_offset=1,          # MoE on odd layers
    attn_every=8,
    attn_offset=3,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,        # d_inner=8192 -> 128 ssm heads
    ssm_groups=1,
    ssm_conv=4,
    act="swiglu",
    norm="rmsnorm",
    pos="none",            # jamba has no positional encoding
)
