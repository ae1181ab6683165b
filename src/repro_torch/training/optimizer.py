"""AdamW + cosine schedule + global-norm clipping, as plain functions on
tensor dicts.

Counterpart of ``repro.training.optimizer``.  The state mirrors the
parameter dict (``m``, ``v`` in float32 whatever the parameter dtype);
the schedule, the clip scale and the bias corrections are float32
tensors on the parameters' device, computed as the JAX package computes
them, so no Python float rounds differently.

``apply_updates`` goes leaf by leaf, in slices of axis 0 of a large
leaf, and updates ``m`` and ``v`` IN PLACE (the returned state holds the
same tensors): at qwen2.5-3b's full width they are 24.7 GB, too much to
hold twice.  The parameters come back as new tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.compression import row_slices
from repro_torch.core.pytree_io import flatten_params, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any                  # f32 dict like params
    v: Any                  # f32 dict like params


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_accum: int = 1      # microbatches per step (activation-memory knob)


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def init_state(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(flatten_params(params).values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=_map(zeros, params), v=_map(zeros, params))


def state_from_jax(state: Any, *, device) -> AdamWState:
    """Carry the JAX package's ``AdamWState`` across: ``state`` is its
    ``(step, m, v)`` after ``jax.device_get`` (nested numpy dicts)."""
    from repro_torch.models.model import params_from_jax

    step, m, v = state
    return AdamWState(step=torch.tensor(int(step), dtype=torch.int32, device=device),
                      m=params_from_jax(m, device=device),
                      v=params_from_jax(v, device=device))


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    # tensor divisors: CUDA divides by a host scalar as a reciprocal product
    warm = torch.clamp(step / step.new_tensor(max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / step.new_tensor(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    parts = [t[s].float().square().sum() for s in row_slices(t)]
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in
    sorted-key order (``tree_leaves``')."""
    return torch.sqrt(sum(_square_sum(leaf) for leaf in flatten_params(tree).values()))


def _decay_mask(name: str) -> bool:
    """No weight decay on norms/biases/1-D dynamics params (``name`` is the
    '/'-joined path)."""
    return not any(k in name for k in ("norm", "bias", "A_log", "dt_bias",
                                       "a_param", "D_skip"))


def apply_updates(
    params: Any, grads: Any, state: AdamWState, cfg: OptimizerConfig,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    # a tensor numerator: ``scalar / tensor`` would multiply by a reciprocal
    scale = torch.clamp(gnorm.new_tensor(cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    flat_g, flat_m, flat_v = (flatten_params(t) for t in (grads, state.m, state.v))
    new_params = {}
    for name, p in flatten_params(params).items():
        p = p.detach()
        g, m, v = flat_g[name], flat_m[name], flat_v[name]
        decay = _decay_mask(name)
        out = torch.empty_like(p)
        for s in row_slices(p):
            g32 = g[s].float() * scale
            m[s] = b1 * m[s] + (1 - b1) * g32
            v[s] = b2 * v[s] + (1 - b2) * g32 * g32
            delta = (m[s] / bc1) / (torch.sqrt(v[s] / bc2) + cfg.eps)
            p32 = p[s].float()
            if decay:
                delta = delta + cfg.weight_decay * p32
            out[s] = (p32 - lr * delta).to(p.dtype)
        new_params[name] = out
    metrics = {"grad_norm": gnorm, "lr": lr}
    return unflatten(new_params), AdamWState(step=step, m=state.m, v=state.v), metrics
