"""Architecture registry of the port — importing this package registers
every config the port can run: the dense decoders ``qwen2.5-3b``,
``granite-34b``, ``minitron-8b`` and ``nemotron-4-15b`` (SwiGLU or
squared-ReLU MLP, GQA groups up to 48).  The other architectures of
``repro.configs`` (MLA, MoE, SSM, RG-LRU, LayerNorm front ends) wait for
their model code (ROADMAP, "the other architectures")."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register, smoke_variant)

# registration side effects
from repro_torch.configs import (  # noqa: F401
    granite_34b,
    minitron_8b,
    nemotron_4_15b,
    qwen2_5_3b,
)

__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "smoke_variant"]
