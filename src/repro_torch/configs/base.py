"""Model configuration dataclass shared by every architecture.

A single frozen dataclass covers the 10 assigned architectures plus the
paper's own evaluation models (DeepSeekV2-Lite, Qwen1.5-MoE,
SwitchTransformers-Large-128).  Family-specific fields default to "off".
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert ffn width
    moe_every: int = 1           # a layer is MoE iff (idx % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense: int = 0         # first N layers use the dense MLP (deepseek-v2)
    capacity_factor: float = 1.25
    router_norm_topk: bool = False   # qwen-moe style renormalised top-k probs
    router_scoring: str = "softmax"  # softmax | sigmoid (DeepSeek-V3's
                                     # noaux_tc: choose by sigmoid scores
                                     # plus a per-expert correction bias,
                                     # weigh by the unbiased scores)
    routed_scale: float = 1.0        # a sigmoid router's gates x this
                                     # (routed_scaling_factor)
    # perf knobs (0/off = paper-era GShard defaults; see EXPERIMENTS.md §Perf)
    moe_group_size: int = 0          # split sequences into dispatch groups of
                                     # this many tokens (capacity ∝ group size,
                                     # so dispatch-einsum FLOPs drop linearly)
    moe_ep_constraint: bool = False  # force all-to-all EP activation layout
                                     # instead of letting GSPMD gather weights
    moe_pad_to: int = 0              # pad expert stacks to this count so EP
                                     # divides the mesh (e.g. 60 -> 64); the
                                     # router never selects padding experts
    attn_f32_inputs: bool = True     # False: feed bf16 operands to the score
                                     # einsums (f32 MXU accumulation) — halves
                                     # attention HBM traffic; softmax stays f32

    # ---- attention ----
    attn: str = "gqa"            # gqa | mla | none
    qk_norm: bool = False
    kv_lora_rank: int = 0        # MLA
    q_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    rope_theta: float = 10000.0
    mrope: bool = False          # qwen2-vl multimodal rope (3 position channels)
    pos: str = "rope"            # rope | learned | none

    # ---- ssm / hybrid ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0          # hybrid: one attention layer per `attn_every`
    attn_offset: int = 3         # local index of the attention layer in the period

    # ---- encoder-decoder ----
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500      # stub-frontend encoder length (whisper 30 s)

    # ---- misc ----
    act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    frontend: str = "none"       # none | audio | vision  (stub: precomputed embeds)
    embed_inputs: bool = True    # False -> input_specs provide embeddings directly
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 524288

    # ---- distribution hints (validated in distributed/sharding.py) ----
    tp_mode: str = "auto"        # auto | head | feature
    moe_mode: str = "auto"       # auto | ep | tp

    # ---- ZipMoE applicability ----
    zipmoe: str = "auto"         # auto | expert | dense | off

    def __post_init__(self):
        if self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: router_scoring="
                             f"{self.router_scoring!r} (softmax or sigmoid)")
        if self.router_scoring == "softmax" and self.routed_scale != 1.0:
            raise ValueError(f"{self.name}: routed_scale "
                             f"{self.routed_scale} needs the sigmoid router")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.zipmoe == "auto":
            object.__setattr__(
                self, "zipmoe", "expert" if self.n_experts > 0 else "dense")

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def moe_layer(self, idx: int) -> bool:
        """Is decoder layer `idx` a MoE layer?"""
        if not self.is_moe:
            return False
        if idx < self.first_dense:
            return False
        return idx % self.moe_every == self.moe_offset

    def attn_layer(self, idx: int) -> bool:
        """Is decoder layer `idx` an attention layer? (hybrid archs)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return idx % self.attn_every == self.attn_offset
        return True

    # ---- parameter counting (for roofline MODEL_FLOPS = 6 N D) ----------
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts."""
        d, V = self.d_model, self.vocab_size
        embed = V * d
        head = 0 if self.tie_embeddings else V * d
        total = embed + head
        active = embed + head

        def attn_params() -> int:
            if self.attn == "mla":
                p = 0
                if self.q_lora_rank:
                    p += d * self.q_lora_rank
                    p += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                else:
                    p += d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                p += d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            hd = self.head_dim
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

        def mlp_params(width: int) -> int:
            n_mat = 3 if self.act == "swiglu" else 2
            return n_mat * d * width

        def ssm_params() -> int:
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            p = d * (2 * di + 2 * g * n + h)        # z,x,B,C,dt projections
            p += self.ssm_conv * (di + 2 * g * n)   # depthwise conv
            p += h * 2                              # A_log, D
            p += di * d                             # out_proj
            return p

        for i in range(self.n_layers):
            if self.family == "ssm" or (self.family == "hybrid" and not self.attn_layer(i)):
                total += ssm_params(); active += ssm_params()
            else:
                total += attn_params(); active += attn_params()
            if self.family == "ssm":
                continue
            if self.moe_layer(i):
                e = mlp_params(self.d_expert)
                total += self.n_experts * e + self.n_shared_experts * e + d * self.n_experts
                if self.router_scoring == "sigmoid":     # the correction bias
                    total += self.n_experts
                active += self.top_k * e + self.n_shared_experts * e + d * self.n_experts
            else:
                total += mlp_params(self.d_ff); active += mlp_params(self.d_ff)
        if self.encoder_decoder:
            for _ in range(self.n_enc_layers):
                total += attn_params() + mlp_params(self.d_ff)
                active += attn_params() + mlp_params(self.d_ff)
            # decoder cross-attention blocks
            total += self.n_layers * attn_params()
            active += self.n_layers * attn_params()
        return {"total": total, "active": active}


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant of `cfg` for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=1024,
    )
    if cfg.is_moe:
        small.update(n_experts=min(cfg.n_experts, 8),
                     top_k=min(cfg.top_k, 2),
                     d_expert=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.attn == "mla":
        small.update(kv_lora_rank=32, q_lora_rank=(48 if cfg.q_lora_rank else 0),
                     qk_rope_dim=16, qk_nope_dim=16, v_head_dim=32)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.encoder_decoder:
        small.update(n_enc_layers=min(cfg.n_enc_layers, 2), enc_seq_len=64)
    small.update(overrides)
    small["name"] = cfg.name + "-smoke"
    return dataclasses.replace(cfg, **small)
