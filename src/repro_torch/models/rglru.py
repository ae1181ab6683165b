"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``:
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t), with the gated decay
a_t = exp(-c * r_t * softplus(lambda)).  Prefill evaluates the linear
recurrence over L with a log-depth doubling scan (the JAX package's
``lax.associative_scan``, same combine); decode is the single step.  The
block is the Griffin recipe around it: a parallel GeLU gate branch, a
causal conv1d on the recurrent branch, the gated output.  Plain PyTorch
on every device (the JAX package has no Pallas kernel here).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.ssm import causal_conv, softplus

_C = 8.0  # Griffin's fixed gate sharpness


def a_param_init(width: int) -> np.ndarray:
    """The JAX package's lambda: a in [0.9, 0.999] at r = 1 (Griffin's
    appendix), from ``np.random.default_rng(42)``, through the inverse
    softplus, in f32 — the same values in both packages."""
    u = np.random.default_rng(42).uniform(0.9, 0.999, size=(width,)) ** 2
    return np.log(np.expm1(-np.log(u) / _C)).astype(np.float32)


def init_rglru(cfg, lead: Tuple[int, ...], normal: Callable, device) -> Dict[str, Any]:
    """Random block weights with the leading axes ``lead`` (see
    ``ssm.init_ssm``): matrices and conv taps from ``normal(shape, scale,
    dtype)``, the conv bias 0, ``a_param`` from :func:`a_param_init`."""
    d, w, k, dt = cfg.d_model, cfg.lru_width, cfg.ssm_conv, cfg.dtype
    a_param = torch.from_numpy(a_param_init(w)).to(device)
    return {
        "w_gate": normal((*lead, d, w), d ** -0.5, dt),
        "w_x": normal((*lead, d, w), d ** -0.5, dt),
        "conv_w": normal((*lead, k, w), k ** -0.5, dt),
        "conv_b": torch.zeros((*lead, w), dtype=dt, device=device),
        "w_r": normal((*lead, w, w), w ** -0.5, dt),
        "w_i": normal((*lead, w, w), w ** -0.5, dt),
        "a_param": a_param.expand(*lead, w).clone(),
        "w_out": normal((*lead, w, d), w ** -0.5, dt),
    }


def _rglru_scan(u: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
                h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, r, i (B, L, W) f32.  Returns (h (B, L, W), the final state (B, W)).

    The pairs (a_t, b_t) compose as (a_r a_l, a_r b_l + b_r), the JAX
    combine; a Hillis-Steele doubling applies it over offsets 1, 2, 4, ...
    in ceil(log2 L) rounds of whole-tensor ops (a Python step per token
    would be L launches a layer).  Out of place, so autograd records it."""
    a = torch.exp(-_C * r * softplus(a_param))                    # (B, L, W)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)
    if h0 is not None:
        # fold the entering state into the first step: h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    length, d = b.shape[1], 1
    while d < length:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def rglru_block(p: Dict[str, Any], xin: torch.Tensor, cfg, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin recurrent block: gate = x @ w_gate, u = conv(x @ w_x) (no
    activation), r and i the f32 sigmoid gates of u, the RG-LRU over u,
    GeLU (tanh form, ``jax.nn.gelu``'s default) of the gate times h, then
    w_out.  ``cache`` holds ``conv`` (B, K-1, W) in the model dtype and
    ``state`` (B, W) f32; one token with a cache takes the single step.
    Returns (out, the new cache as new tensors, or ``None``)."""
    f32 = torch.float32
    gate = xin @ p["w_gate"]
    u, new_conv = causal_conv(xin @ p["w_x"], p["conv_w"], p["conv_b"],
                              None if cache is None else cache["conv"])
    u32 = u.to(f32)
    r = torch.sigmoid(u32 @ p["w_r"].to(f32))
    i = torch.sigmoid(u32 @ p["w_i"].to(f32))
    if u.shape[1] == 1 and cache is not None:
        a = torch.exp(-_C * r[:, 0] * softplus(p["a_param"]))
        final = (a * cache["state"].to(f32)
                 + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * (i[:, 0] * u32[:, 0]))
        h = final[:, None]
    else:
        h, final = _rglru_scan(u32, r, i, p["a_param"],
                               None if cache is None else cache["state"].to(f32))
    out = F.gelu(gate.to(f32), approximate="tanh") * h
    out = out.to(xin.dtype) @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "state": final.to(cache["state"].dtype)}
    return out, new_cache


def init_rglru_cache(cfg, lead: Tuple[int, ...], dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed cache with leading axes ``lead``: ``conv`` (*lead, K-1, W)
    in ``dtype`` and the f32 ``state`` (*lead, W)."""
    return {
        "conv": torch.zeros((*lead, cfg.ssm_conv - 1, cfg.lru_width), dtype=dtype,
                            device=device),
        "state": torch.zeros((*lead, cfg.lru_width), dtype=torch.float32, device=device),
    }
