"""granite-34b — llama-arch code model, deep + MQA [arXiv:2405.04324].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="swiglu",
    source="arXiv:2405.04324 (Granite Code Models)",
))
