"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, ssm_state=128, vocab 50280.
d_inner = 2*768 = 1536, 24 SSD heads of dim 64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
))
