"""whisper-small [audio]: 12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.

Encoder-decoder; conv frontend STUBBED (input_specs supplies precomputed
frame embeddings for the 1500-frame encoder context). [arXiv:2212.04356]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    qkv_bias=True,
    rope_theta=10_000.0,         # positions: sinusoidal enc / learned dec -> rope-free attn, abs embed
    norm="layernorm",
    mlp="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=12, n_encoder_ctx=1500),
    max_position=448,
)
