"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: logical heads; cache is the shared latent
    d_ff=12288,            # dense MLP width (first layer)
    vocab_size=102400,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_expert=1536,
    first_dense=1,
    attn="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,          # qk_nope + qk_rope
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)
