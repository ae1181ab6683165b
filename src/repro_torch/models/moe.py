"""Mixture-of-Experts block of the port: shared experts plus fine-grained
routed experts (DeepSeekMoE / DeepSeek-V2: top-k of E small experts and
always-on shared experts).

Counterpart of ``repro/models/moe.py``, with its capacity semantics kept
exactly: each batch row ranks its own tokens within each expert (the
cumsum of a one-hot in flat order ``i·k + j``), tokens past the row's
capacity are dropped, and the kept ones go through an (B, E, C, D)
buffer, one batched product per expert-stacked weight, and back weighted
by their router probabilities.  The JAX package computes the dispatch
and the expert products outside any Pallas kernel, so here they are
plain PyTorch too.

Every shape is static and nothing reads a value back to the host (no
``.item()``, ``nonzero``, boolean-mask indexing or ``unique``), so the
block runs inside the CUDA graphs of the decode step and the prefill
chunk (``serving/compiled.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import hint_sharding, index_add_rows, matmul, mlp_block


def capacity(s: int, cfg) -> int:
    """Slots per expert in one batch row of ``s`` tokens: a Python int of
    the static shapes, at least 8."""
    k, e = cfg.experts_per_token, cfg.num_experts
    return max(int(math.ceil(s * k / e * cfg.moe_capacity_factor)), 8)


def route(p: Dict[str, Any], x: torch.Tensor, cfg):
    """Router of one block: (probs (B, S, E) f32, top_p (B, S, k) f32,
    top_e (B, S, k) int64), top_p renormalized over the k picks when the
    config says so."""
    logits = matmul(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if cfg.moe_renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    return probs, top_p, top_e


def dispatch(top_e: torch.Tensor, e: int, cap: int):
    """Per-row capacity slots of the flat assignments ``i·k + j``:
    (flat_e (B, S·k), safe_pos (B, S·k), keep (B, S·k) bool).  A token's
    rank within its expert is the count of earlier assignments to that
    expert in the row; a rank past ``cap`` is dropped and parked on slot
    ``cap - 1``."""
    b = top_e.shape[0]
    flat_e = top_e.reshape(b, -1)
    onehot = (flat_e[..., None] == torch.arange(e, device=top_e.device)).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    pos = (pos_in_e * onehot).sum(-1)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    return flat_e, safe_pos, keep


def moe_block(p: Dict[str, Any], x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), the switch aux loss f32 scalar).

    Dispatch is per batch row (the JAX package's per-device capacity
    semantics): a row scatters its kept tokens into its own (E, C, D)
    slice by addition, so a dropped token (zeroed) adds nothing to the
    kept token it shares slot ``C - 1`` with.  The combine gathers each
    assignment's row back in flat order, weights it by ``top_p · keep``
    cast to the activation dtype, and sums over the k picks."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs, top_p, top_e = route(p, x, cfg)

    # switch-style aux loss: mean assignment fraction * mean prob, per expert
    assign = (top_e[..., None] == torch.arange(e, device=x.device)).float()  # (B,S,k,E)
    frac_tokens = assign.sum(2).mean((0, 1))
    frac_probs = probs.mean((0, 1))
    aux = (frac_tokens * frac_probs).sum() * e

    cap = capacity(s, cfg)
    flat_e, safe_pos, keep = dispatch(top_e, e, cap)
    vals = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d)  # (B, S·k, D)
    vals = vals.masked_fill(~keep[..., None], 0)
    rows = torch.arange(b, device=x.device)[:, None]
    slot = (rows * e + flat_e) * cap + safe_pos                   # (B, S·k)
    buf = torch.zeros((b * e * cap, d), dtype=x.dtype, device=x.device)
    buf = index_add_rows(buf, slot.reshape(-1), vals.reshape(-1, d))
    buf = hint_sharding(buf.reshape(b, e, cap, d), "batch", "model", None, None)

    w = p["experts"]
    g = torch.einsum("becd,edf->becf", buf, w["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, w["w_up"])
    h = F.silu(g) * u
    out_buf = torch.einsum("becf,efd->becd", h, w["w_down"]).to(x.dtype)
    out_buf = hint_sharding(out_buf, "batch", "model", None, None)      # (B, E, C, D)

    gathered = out_buf[rows, flat_e, safe_pos]                   # (B, S·k, D)
    weight = top_p.reshape(b, s * k) * keep.to(top_p.dtype)
    y = (gathered * weight[..., None].to(gathered.dtype)).reshape(b, s, k, d).sum(2)
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + mlp_block(p["shared"], x, cfg)
    return y, aux
