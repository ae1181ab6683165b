"""Model code of the port: the dense GQA decoder (qwen2.5-3b, granite-34b,
minitron-8b, nemotron-4-15b)."""
from repro_torch.models.model import (forward, init_cache, init_params, lm_loss,
                                      params_from_jax)

__all__ = ["forward", "init_cache", "init_params", "lm_loss", "params_from_jax"]
