"""switch-large-128 — paper evaluation model (Fedus et al., 2022).

T5-Large backbone: 24 enc + 24 dec layers, d_model 1024, 16H, d_ff 2816,
MoE every other layer with 128 experts top-1.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="switch-large-128",
    family="audio",            # reuses the enc-dec code path (text enc-dec)
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=32128,
    n_experts=128,
    top_k=1,
    d_expert=2816,
    moe_every=2,
    moe_offset=1,
    encoder_decoder=True,
    n_enc_layers=24,
    enc_seq_len=512,
    act="gelu",
    norm="rmsnorm",            # T5 uses RMSNorm
    pos="learned",
    frontend="none",
)
