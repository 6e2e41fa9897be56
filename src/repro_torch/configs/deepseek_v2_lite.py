"""DeepSeek-V2-Lite [mla_moe], port-only: 27L d_model=2048, multi-head
latent attention with 16 heads (no q compression; kv latent 512, plain
q/k 128 and rotary 64 a head, v 128), YaRN x40 over 4,096 original
positions; layer 0 a dense SwiGLU of 10,944, layers 1-26 64 routed
experts of 1,408, top-6 by softmax with the gates not renormalised, plus
2 shared experts with no gate; vocab 102,400, untied head, RMSNorm eps
1e-6.  [hf:deepseek-ai/DeepSeek-V2-Lite]
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, YarnScaling

CONFIG = MLAConfig(
    name="deepseek-v2-lite",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,                   # a head's query and key: 128 plain + 64 rotary
    d_ff=10_944,                  # the dense layer's width
    vocab_size=102_400,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, renormalize=False,
                  shared_gated=False),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling=YarnScaling(factor=40.0, original_max_position=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
    first_k_dense_replace=1,
    norm_eps=1e-6,
    max_position=163_840,
)
