"""granite-4.0-h-small [hybrid_moe], port-only: 40L d_model=4096, 4 periods
of [mamba x5, attention, mamba x4]; Mamba-2 128 heads of 64, d_state 128,
1 group, conv 4 with bias, chunk 256; GQA 32/8 heads of 128 without
positions (NoPE); every layer followed by 72 experts of width 768, top-10,
and an ungated shared expert of width 1536; vocab 100,352, tied
embeddings.  [hf:ibm-granite/granite-4.0-h-small]
"""
from repro_torch.configs.base import HybridMoEConfig, Mamba2Config, MoEConfig

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=768,                     # per-expert FF width
    vocab_size=100_352,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, d_ff_expert=768,
                  shared_gated=False),
    ssm=Mamba2Config(version=2, d_state=128, d_conv=4, expand=2,
                     head_dim=64, chunk=256, n_groups=1),
    layer_types=PERIOD * 4,
    shared_d_ff=1536,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
    max_position=131_072,
)
