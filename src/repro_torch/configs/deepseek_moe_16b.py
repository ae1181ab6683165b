"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=102400.
Standard attention (no MLA).  Uniform MoE layers (HF uses a dense first
layer), as in the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    source="arXiv:2401.06066 (DeepSeekMoE)",
))
