"""Architecture registry of the port — importing this package registers
every config the port can run: the dense decoders ``qwen2.5-3b``,
``granite-34b``, ``minitron-8b`` and ``nemotron-4-15b`` (SwiGLU or
squared-ReLU MLP, GQA groups up to 48), the DeepSeek MoE models
``deepseek-moe-16b`` (MHA) and ``deepseek-v2-lite-16b`` (MLA), and the
recurrent family: ``mamba2-130m`` (Mamba-2 SSD, attention-free) and
``recurrentgemma-2b`` (RG-LRU with sliding-window attention).  The other
architectures of ``repro.configs`` (LayerNorm with the audio and vision
front ends) wait for their model code (ROADMAP, "the other
architectures")."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register, smoke_variant)

# registration side effects
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    granite_34b,
    mamba2_130m,
    minitron_8b,
    nemotron_4_15b,
    qwen2_5_3b,
    recurrentgemma_2b,
)

__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "smoke_variant"]
