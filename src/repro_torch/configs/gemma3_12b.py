"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-*-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,                   # gemma3 uses head_dim 256 (≠ d_model/heads)
    d_ff=15_360,
    vocab_size=262_144,
    norm="rmsnorm",
    mlp="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,       # global layers; local layers use 10k (approximated)
    sliding_window=1024,
    local_global_ratio=(5, 1),    # 5 local layers, then 1 global
    tie_embeddings=True,
)
