"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (3-section rotary over t/h/w), dynamic resolution.
Vision patch frontend STUBBED per the assignment (backbone only; input_specs
supplies M-RoPE position ids, patch embeddings precomputed upstream).
[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # head_dim/2 = 64 split across t/h/w
)
