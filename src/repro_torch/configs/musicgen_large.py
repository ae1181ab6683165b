"""musicgen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (codec codebook).
LayerNorm (GPT-style).  As in the JAX package's config, RoPE stands in
for the original's learned positions, and the text-conditioning
cross-attention is left out: the ``"audio"`` front end is a stub, the
backbone takes codec tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="swiglu",
    norm_layernorm=True,
    frontend="audio",
    source="arXiv:2306.05284 (MusicGen)",
))
