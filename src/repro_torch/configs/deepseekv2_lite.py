"""deepseekv2-lite — paper evaluation model (Liu et al., 2024).

27L, d_model 2048, 16H MLA (kv_lora 512, no q-lora), 64 routed experts top-6
+ 2 shared, expert width 1408, first layer dense (d_ff 10944).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseekv2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    first_dense=1,
    attn="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,
    act="swiglu",
    norm="rmsnorm",
)
