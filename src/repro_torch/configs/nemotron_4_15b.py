"""nemotron-4-15b — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="squared_relu",
    source="arXiv:2402.16819 (Nemotron-4)",
))
