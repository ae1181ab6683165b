"""minitron-8b — pruned Nemotron-4 [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, squared-ReLU
(inherits the Nemotron family MLP).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="squared_relu",
    source="arXiv:2407.14679 (Minitron)",
))
