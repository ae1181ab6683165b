"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in plain tensor ops:
the wrappers in ``paged_attention.py`` / ``masked_dequant.py`` /
``delta_apply.py`` / ``flash_attention.py`` / ``quant_matmul.py`` take
them for CPU tensors, the CPU tests hold them against the JAX oracles
(``repro.kernels.ref``), and ``chip_smoke.py`` holds each kernel against
them on the card.  Like the JAX oracles they mask with -1e30 (the
model's own softmax uses ``finfo.min``, see ``models/layers.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def masked_dequant(codes: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Fused dequant + license-interval mask (paper §3.5).

    w = codes * scale (f32, scale broadcast to codes: (R, C) codes, or a
    stacked (U, R, C) leaf whose scale has a leading axis of U or 1); w is
    zeroed where lo[i] <= |w| < hi[i] for any interval i.  Intervals with
    lo == hi are inert padding.  Elementwise, so a stacked leaf gives,
    slice by slice, what the 2-D form gives on each slice.
    """
    w = codes.to(torch.float32) * scale.to(torch.float32)
    mag = w.abs()
    lo = lo.to(torch.float32)
    hi = hi.to(torch.float32)
    dead = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    for i in range(lo.shape[0]):
        dead |= (mag >= lo[i]) & (mag < hi[i])
    return torch.where(dead, torch.zeros_like(w), w).to(out_dtype)


def delta_apply(buf: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
                *, donate: bool = False) -> torch.Tensor:
    """Sparse scatter-set ``buf[indices] = values`` into a flat (N,) buffer.

    Indices are unique; entries outside ``[0, N)`` are dropped (the JAX
    contract pads with N; a negative index never writes).  Values are
    cast to buf's dtype first (round to nearest even, as ``astype``
    does).  ``donate`` writes into ``buf``; otherwise a copy is returned
    and ``buf`` is untouched."""
    out = buf if donate else buf.clone()
    idx = indices.long()
    keep = (idx >= 0) & (idx < buf.shape[0])
    out[idx[keep]] = values[keep].to(buf.dtype)
    return out


def paged_attention(q: torch.Tensor, k_blocks: torch.Tensor,
                    v_blocks: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention through a block table: gather, then softmax.

    q (B,H,hd); k/v blocks (P,bs,KH,hd); block_tables (B,T) in logical
    order; context_lens (B,) masks positions >= len (including everything
    read through pad table entries).  Returns (B,H,hd) f32.
    """
    b, h, hd = q.shape
    _, bs, kh, _ = k_blocks.shape
    t = block_tables.shape[1]
    groups = h // kh
    tab = block_tables.long()
    k = k_blocks[tab].reshape(b, t * bs, kh, hd).repeat_interleave(groups, dim=2)
    v = v_blocks[tab].reshape(b, t * bs, kh, hd).repeat_interleave(groups, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(hd)
    mask = (torch.arange(t * bs, device=q.device)[None, :]
            < context_lens.to(q.device).long()[:, None])
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[:, None, :].any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhs,bshd->bhd", p, v.float())


def paged_decode_write(k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                       new_k: torch.Tensor, new_v: torch.Tensor,
                       block_ids: torch.Tensor, offsets: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K/V token per lane lands at ``(block_ids[b], offsets[b])``,
    IN PLACE on the block pools (which are returned).

    k/v blocks (P,bs,KH,hd); new_k/new_v (B,KH,hd).  Lanes never share a
    write target except the null block (pad lanes), where any of the
    duplicate writes may win — its content is garbage by contract.
    """
    ids = block_ids.long()
    offs = offsets.long()
    k_blocks[ids, offs] = new_k.to(k_blocks.dtype)
    v_blocks[ids, offs] = new_v.to(v_blocks.dtype)
    return k_blocks, v_blocks


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    groups: int = 1) -> torch.Tensor:
    """Materialized-softmax attention; returns (BH, Sq, hd) f32.

    q (BH, Sq, hd); k/v (BKH, Sk, hd) with BH == BKH * groups (GQA: q
    head ``bh`` reads kv head ``bh // groups``).  Query row i sits at
    position ``q_offset + i``; key j is masked where ``j > pos``
    (``causal``) or ``j <= pos - window`` (``window != 0``).  A row with
    no valid key is 0."""
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kr = k.float().repeat_interleave(groups, dim=0)
    vr = v.float().repeat_interleave(groups, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), kr) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True)[None], p, torch.zeros_like(p))
    return torch.einsum("bqk,bkh->bqh", p, vr)


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """x (M, K) @ (codes (K, N) int8 * scale (N,)) -> (M, N) in out_dtype.

    The weight is dequantized in f32 (per output column), the product
    accumulates in f32, and the result is cast once at the end."""
    w = codes.to(torch.float32) * scale.to(torch.float32)[None, :]
    return (x.to(torch.float32) @ w).to(out_dtype)
