"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA (GQA kv=16)
    head_dim=128,
    d_ff=1408,             # routed expert width
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_expert=1408,
    router_norm_topk=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
)
