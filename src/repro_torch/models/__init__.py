"""Model code of the port: the dense GQA decoders (qwen2.5-3b, granite-34b,
minitron-8b, nemotron-4-15b), the DeepSeek MoE / MLA decoders
(deepseek-moe-16b, deepseek-v2-lite-16b) and the recurrent family
(mamba2-130m's Mamba-2 blocks, ``ssm.py``; recurrentgemma-2b's RG-LRU
blocks, ``rglru.py``, beside sliding-window attention)."""
from repro_torch.models.model import (forward, init_cache, init_params, lm_loss,
                                      params_from_jax)

__all__ = ["forward", "init_cache", "init_params", "lm_loss", "params_from_jax"]
