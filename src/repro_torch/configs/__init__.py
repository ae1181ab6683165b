"""Architecture registry of the port — importing this package registers
every config of the JAX package's assigned pool: the dense decoders
``qwen2.5-3b``, ``granite-34b``, ``minitron-8b`` and ``nemotron-4-15b``
(SwiGLU or squared-ReLU MLP, GQA groups up to 48), the DeepSeek MoE
models ``deepseek-moe-16b`` (MHA) and ``deepseek-v2-lite-16b`` (MLA), the
recurrent family: ``mamba2-130m`` (Mamba-2 SSD, attention-free) and
``recurrentgemma-2b`` (RG-LRU with sliding-window attention), and the
front-end stubs ``musicgen-large`` (LayerNorm, MHA at head dim 64, codec
tokens) and ``internvl2-26b`` (GQA 48/8 after a projected vision
prefix)."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register, smoke_variant)

# registration side effects
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    granite_34b,
    internvl2_26b,
    mamba2_130m,
    minitron_8b,
    musicgen_large,
    nemotron_4_15b,
    qwen2_5_3b,
    recurrentgemma_2b,
)

# the assigned pool, in the JAX package's order (the launch tools'
# ``--all`` sweeps it)
ASSIGNED_ARCHS = (
    "mamba2-130m",
    "qwen2.5-3b",
    "musicgen-large",
    "recurrentgemma-2b",
    "deepseek-v2-lite-16b",
    "nemotron-4-15b",
    "internvl2-26b",
    "minitron-8b",
    "deepseek-moe-16b",
    "granite-34b",
)

__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "smoke_variant", "ASSIGNED_ARCHS"]
