"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 (fine-grained experts).
[hf:ibm-granite/granite-3.0-*-base]

NOTE: the assignment line says both "MoE 40e top-8" and "32 experts top-8";
we implement the explicit shape field (40 experts, top-8) — see DESIGN.md §9.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                     # per-expert FF width (fine-grained)
    vocab_size=49_155,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)
