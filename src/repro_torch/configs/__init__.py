"""Architecture registry of the port — importing this package registers
every config the port can run.  Only the dense GQA ``qwen2.5-3b`` is
ported so far; the other architectures of ``repro.configs`` wait for
their model code (ROADMAP, "the other architectures")."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register, smoke_variant)

# registration side effects
from repro_torch.configs import qwen2_5_3b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "smoke_variant"]
