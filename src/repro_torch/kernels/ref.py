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

import numpy as np
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


def _host_tensor(arr) -> torch.Tensor:
    """A host array as a CPU tensor; bf16 bits (``np.uint16``) become a
    ``torch.bfloat16`` view of a copy."""
    arr = np.require(arr, requirements=("C", "W"))
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def delta_apply_parts(segments) -> None:
    """Plain version of the staged sync's one apply per step: each segment
    of ``kernels.delta_apply`` in order, a rows part through
    :func:`delta_apply` in place, a run (a chunk page) as a slice copy."""
    for s in segments:
        dev = s.dst.device
        if hasattr(s, "indices"):
            delta_apply(s.dst, _host_tensor(s.indices).to(dev),
                        _host_tensor(s.values).to(dev), donate=True)
        else:
            data = _host_tensor(s.data).reshape(-1).to(dev)
            s.dst[s.offset: s.offset + data.numel()].copy_(data)


def delta_apply_packed(packed: torch.Tensor, map_off: int, payload_off: int,
                       n_tiles: int, dsts) -> None:
    """Plain unpacker: apply a packed step (``kernels.delta_apply.plan_step``
    / ``write_step``) tile by tile, exactly as ``csrc/delta_apply.cu``
    reads it: each tile's segment through the tile map, a rows tile's
    entries from the payload through :func:`delta_apply`, a run tile's
    bytes copied.  ``packed`` is a CPU uint8 tensor; ``dsts`` are the
    flat destinations, which the table names by address."""
    from repro_torch.kernels import delta_apply as layout

    if n_tiles == 0:
        return
    by_ptr = {t.data_ptr(): t for t in dsts}
    tile_seg = packed[map_off: map_off + 4 * n_tiles].view(torch.int32).tolist()
    words = layout.SEGMENT_WORDS
    table = packed[: map_off].view(torch.int64)
    for tile, k in enumerate(tile_seg):
        dst_ptr, size, count, dst_off, idx_off, val_off, first, kind_flags = \
            table[k * words: (k + 1) * words].tolist()
        kind, flags = kind_flags & 0xFFFFFFFF, kind_flags >> 32
        dst, t = by_ptr[dst_ptr], tile - first
        if kind == layout.RUN:
            es = (flags >> 8) & 0xFF
            lo = t * layout.TILE_BYTES
            hi = min(lo + layout.TILE_BYTES, count * es)
            src = payload_off + val_off
            dst.view(torch.uint8)[dst_off * es + lo: dst_off * es + hi] = packed[src + lo: src + hi]
            continue
        lo = t * layout.TILE_ROWS
        hi = min(lo + layout.TILE_ROWS, count)
        isz, itype = (4, torch.int32) if flags & layout.IDX32 else (8, torch.int64)
        vsz, vtype = (2, torch.bfloat16) if flags & layout.VAL_BF16 else (4, torch.float32)
        i0, v0 = payload_off + idx_off, payload_off + val_off
        idx = packed[i0 + lo * isz: i0 + hi * isz].view(itype)
        val = packed[v0 + lo * vsz: v0 + hi * vsz].view(vtype)
        if dst.numel() != size or (dst.dtype == torch.bfloat16) != bool(flags & layout.DST_BF16):
            raise ValueError("delta_apply_packed: the table's destination does not match")
        delta_apply(dst, idx, val, donate=True)


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
