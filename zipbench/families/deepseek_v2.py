"""DeepSeek-V2 (``model_type`` ``deepseek_v2``): latent attention, a dense
first layer, then softmax-routed top-k experts plus shared ones."""
from __future__ import annotations

from zipbench.reference import mla_moe

REFERENCE = mla_moe


def fields(c: dict) -> dict:
    need = {"scoring_func": "softmax", "topk_method": "greedy",
            "routed_scaling_factor": 1, "moe_layer_freq": 1,
            "rms_norm_eps": 1e-06,
            "tie_word_embeddings": False, "attention_bias": False,
            "hidden_act": "silu"}
    for k, v in need.items():
        if c.get(k) != v:
            raise ValueError(f"{c['name']}: {k}={c.get(k)!r}: the port runs "
                             f"{v!r} only")
    rs = c.get("rope_scaling")
    if rs is not None and (rs.get("type") != "yarn" or rs["factor"] > 1):
        # The port rotates by plain RoPE with the plain softmax scale: that
        # is YaRN at factor 1, and no other scaling.
        raise ValueError(f"{c['name']}: rope_scaling={rs!r}: the port runs "
                         f"none, or yarn at factor 1, only")
    return dict(
        family="moe", attn="mla", act="swiglu", norm="rmsnorm",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        n_experts=c["n_routed_experts"], n_shared_experts=c["n_shared_experts"],
        top_k=c["num_experts_per_tok"], d_expert=c["moe_intermediate_size"],
        first_dense=c["first_k_dense_replace"],
        kv_lora_rank=c["kv_lora_rank"], q_lora_rank=c["q_lora_rank"] or 0,
        qk_rope_dim=c["qk_rope_head_dim"], qk_nope_dim=c["qk_nope_head_dim"],
        v_head_dim=c["v_head_dim"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        rope_theta=float(c["rope_theta"]),
        router_norm_topk=bool(c["norm_topk_prob"]))
