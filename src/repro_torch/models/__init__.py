"""Model code of the port: the dense GQA decoder (qwen2.5-3b family)."""
from repro_torch.models.model import (forward, init_cache, init_params, lm_loss,
                                      params_from_jax)

__all__ = ["forward", "init_cache", "init_params", "lm_loss", "params_from_jax"]
