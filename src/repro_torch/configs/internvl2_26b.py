"""internvl2-26b — VLM: InternViT (stub) + InternLM2-20B backbone
[arXiv:2404.16821].

LM backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT encoder and MLP projector are a stub, as in the JAX
package: a caller supplies ``num_patches`` precomputed patch embeddings
per image, which the model projects (``vision_proj``) and prepends to the
text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    mlp_type="swiglu",
    frontend="vision",
    num_patches=256,
    source="arXiv:2404.16821 (InternVL 1.5/2 family)",
))
