"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Backbone only: 12 encoder + 12 decoder layers.  The conv frontend is a stub —
`input_specs()` provides precomputed frame embeddings [B, S_enc, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,           # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,         # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_decoder=True,
    n_enc_layers=12,
    enc_seq_len=1500,
    act="gelu",
    norm="layernorm",
    pos="learned",
    frontend="audio",
    embed_inputs=True,     # decoder embeds tokens; encoder takes stub embeds
)
