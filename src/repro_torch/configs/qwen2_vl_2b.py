"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision patch-embedding frontend is a stub —
`input_specs()` provides precomputed patch/text embeddings [B, S, d_model]
plus 3-channel M-RoPE positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    frontend="vision",
    embed_inputs=False,    # takes precomputed embeddings
)
