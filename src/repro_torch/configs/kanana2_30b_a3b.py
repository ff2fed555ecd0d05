"""kanana-2-30b-a3b (Kakao, ``model_type`` deepseek_v3; published
``config.json`` of kakaocorp/kanana-2-30b-a3b-instruct-2601).

48L, d_model 2048, 32H MLA (kv_lora 512, no q-lora, nope 128, rope 64, v
128), 128 routed experts top-6 of width 768 + 2 shared, first layer dense
(d_ff 6144), vocabulary 128256, rope theta 1e6 with no scaling.  The
router is DeepSeek-V3's ``noaux_tc`` at one group: sigmoid scores, chosen
by score + correction bias, the chosen scores renormalised and scaled by
2.448.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kanana-2-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6144,
    vocab_size=128256,
    n_experts=128,
    n_shared_experts=2,
    top_k=6,
    d_expert=768,
    first_dense=1,
    router_norm_topk=True,
    router_scoring="sigmoid",
    routed_scale=2.448,
    attn="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,
    rope_theta=1e6,
    act="swiglu",
    norm="rmsnorm",
)
