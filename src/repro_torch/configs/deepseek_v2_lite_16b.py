"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (qk_nope 128, rope 64, v 128),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, vocab 102400.
(Full V2 has 160 routed experts; this is the Lite model's 64, top-6.)
Uniform MoE across layers (the HF model uses a dense first layer; uniform
keeps the layer stack one stacked unit), as in the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=0,           # MLA defines its own per-head dims
    d_ff=0,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    source="arXiv:2405.04434 (DeepSeek-V2 / V2-Lite)",
))
