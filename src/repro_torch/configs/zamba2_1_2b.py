"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba-2 backbone + shared attention block
applied periodically (same params each invocation). [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,                  # mamba2 backbone layers
    d_model=2048,
    n_heads=32,                   # shared attention block
    n_kv_heads=32,
    d_ff=8192,                    # shared block MLP
    vocab_size=32_000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10_000.0,
    ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, head_dim=64),
    hybrid_period=6,              # shared attn block every 6 mamba layers
)
