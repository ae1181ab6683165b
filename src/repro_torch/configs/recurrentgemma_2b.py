"""recurrentgemma-2b — RG-LRU + local attention, 2 recurrent : 1 attention
[arXiv:2402.19427 Griffin / RecurrentGemma].

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
lru_width=2560, local attention window 2048.
26 = 8 full (rec,rec,attn) units + 2 tail recurrent layers.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="swiglu",
    layer_pattern=("rec", "rec", "attn"),
    window=2048,
    lru_width=2560,
    source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
))
