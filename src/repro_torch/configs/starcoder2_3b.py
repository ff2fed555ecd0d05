"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",            # starcoder2 uses gelu MLP
    norm="layernorm",
    rope_theta=999999.0,
)
