"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 — Mamba-1 architecture. [arXiv:2410.05355]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                       # attention-free, MLP-free Mamba blocks
    vocab_size=65_024,
    norm="rmsnorm",
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, dt_rank=256),
)
