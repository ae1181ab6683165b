"""Kernel-resident paged decode on Hopper: ``paged_attention`` and
``paged_decode_write``.

These replace the Pallas TPU kernels of
``repro/kernels/paged_attention.py`` with hand-written CUDA C++
(``csrc/paged_attention.cu``, built by ``build.load_extension``).  The
serving pool (``serving/paging.py``) stores K/V as fixed-size physical
blocks ``(P, bs, KH, hd)`` shared by every request; a request's cache is
the concatenation of the blocks its block table names.  Decode writes
the step's one K/V token per lane through its block index and then
attends through the table, so no contiguous copy of any sequence exists.

Unlike the JAX version, ``paged_decode_write`` updates the pools **in
place** (PyTorch tensors are mutable), so the donate-the-cache /
adopt-the-outputs exchange of the JAX gateway becomes a direct write.

Each wrapper takes the plain version (``ref.py``) for CPU tensors only;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops, ref

_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _require_cuda(name: str, device: torch.device, tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for label, t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {label} on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def paged_attention(q: torch.Tensor, k_blocks: torch.Tensor,
                    v_blocks: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over a block-paged KV cache; returns (B, H, hd) f32.

    q (B, H, hd); k/v blocks (P, bs, KH, hd) of q's dtype (f32 or bf16);
    block_tables (B, T) int32, whose entry t covers positions
    [t*bs, (t+1)*bs) and must lie in [0, P); context_lens (B,) int32
    valid lengths (pos + 1).  GQA via H == KH * groups; scale 1/sqrt(hd).
    """
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_blocks, v_blocks, block_tables,
                                   context_lens)
    _require_cuda("paged_attention", q.device,
                  (("k_blocks", k_blocks), ("v_blocks", v_blocks),
                   ("block_tables", block_tables),
                   ("context_lens", context_lens), ("q", q)))
    b, h, hd = q.shape
    p, bs, kh, hd_k = k_blocks.shape
    if v_blocks.shape != k_blocks.shape or hd_k != hd:
        raise ValueError(f"paged_attention: k/v blocks {tuple(k_blocks.shape)}/"
                         f"{tuple(v_blocks.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k_blocks.dtype != q.dtype \
            or v_blocks.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/k/v must share one dtype of "
                        f"{_DTYPES}, got {q.dtype}/{k_blocks.dtype}/{v_blocks.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not in {_HEAD_DIMS}")
    if h % kh or h // kh > 32:
        raise ValueError(f"paged_attention: {h} heads over {kh} kv heads "
                         f"(groups must divide and be <= 32)")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables/context_lens must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or context_lens.shape != (b,):
        raise ValueError(f"paged_attention: tables {tuple(block_tables.shape)} / "
                         f"lens {tuple(context_lens.shape)} for batch {b}")
    from repro_torch.kernels.build import load_extension

    out = load_extension().paged_attention(q, k_blocks, v_blocks, block_tables,
                                           context_lens)
    ops.LAUNCHES["paged_attention"] += 1
    return out


def paged_decode_write(k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                       new_k: torch.Tensor, new_v: torch.Tensor,
                       block_ids: torch.Tensor, offsets: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ONE K/V token per lane, in place, at ``(block_ids[b],
    offsets[b])``; returns the (same) pools.

    k/v blocks (P, bs, KH, hd); new_k/new_v (B, KH, hd), cast to the
    pools' dtype; block_ids/offsets (B,) int32.  Lanes never share a
    target except the null block (pad lanes), where any write may win.
    """
    if k_blocks.device.type == "cpu":
        return ref.paged_decode_write(k_blocks, v_blocks, new_k, new_v,
                                      block_ids, offsets)
    _require_cuda("paged_decode_write", k_blocks.device,
                  (("k_blocks", k_blocks), ("v_blocks", v_blocks),
                   ("new_k", new_k), ("new_v", new_v),
                   ("block_ids", block_ids), ("offsets", offsets)))
    b, kh, hd = new_k.shape
    if new_v.shape != new_k.shape or v_blocks.shape != k_blocks.shape \
            or k_blocks.shape[2:] != (kh, hd):
        raise ValueError(f"paged_decode_write: pools {tuple(k_blocks.shape)} / "
                         f"tokens {tuple(new_k.shape)} mismatch")
    for label, t in (("pools", k_blocks), ("v pool", v_blocks),
                     ("new_k", new_k), ("new_v", new_v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"paged_decode_write: {label} dtype {t.dtype} "
                            f"not in {_DTYPES}")
    if v_blocks.dtype != k_blocks.dtype or new_v.dtype != new_k.dtype:
        raise TypeError("paged_decode_write: k/v dtypes differ")
    if block_ids.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or block_ids.shape != (b,) or offsets.shape != (b,):
        raise ValueError("paged_decode_write: block_ids/offsets must be (B,) int32")
    from repro_torch.kernels.build import load_extension

    load_extension().paged_decode_write(k_blocks, v_blocks, new_k, new_v,
                                        block_ids, offsets)
    ops.LAUNCHES["paged_decode_write"] += 1
    return k_blocks, v_blocks
