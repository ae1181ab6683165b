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

``paged_attention`` splits each (lane, kv head)'s table columns over
``S`` blocks (``split_plan``, from host-known shapes only: the wrapper
never reads ``context_lens`` and never synchronises, so a decode step
stays capturable in a CUDA graph); with ``S > 1`` the splits' partials go
to an f32 workspace allocated here and a second kernel combines them in
split order.  One call is one count in ``ops.LAUNCHES``, the combine
included.  Both run on every layer of every decode step, so their shape,
dtype, device and contiguity checks are in the extension
(``csrc/bindings.cpp``, raising ``ValueError`` / ``TypeError``): in Python
they cost more host time per call than the extension call itself
(PERF.md).

Each wrapper takes the plain version (``ref.py``) for CPU tensors only;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import load_extension

SPLIT_BLOCKS_PER_SM = 4   # split blocks the plan aims for on each SM
SPLIT_MIN_KEYS = 32       # keys per split at least (where the table has them)
SPLIT_MAX_KEYS = 512      # keys per split at most: their scores stay in shared memory


def split_plan(n_tab: int, block_size: int, batch: int, kv_heads: int,
               num_sms: int) -> Tuple[int, int]:
    """(splits, cols): split s of each (lane, kv head) walks table columns
    [s * cols, (s + 1) * cols).  Enough splits that the grid of batch x
    kv_heads x splits holds at least ``SPLIT_BLOCKS_PER_SM`` blocks per SM, each
    split at least ``SPLIT_MIN_KEYS`` and at most ``SPLIT_MAX_KEYS`` keys
    (one page where a page holds more) and no more columns than the table
    has.  Reads shapes only, never the context lengths."""
    n_tab, bs = max(1, n_tab), max(1, block_size)
    want = -(-SPLIT_BLOCKS_PER_SM * num_sms // max(1, batch * kv_heads))
    cols = max(n_tab // want, -(-SPLIT_MIN_KEYS // bs))
    cols = max(1, min(cols, SPLIT_MAX_KEYS // bs, n_tab))
    return -(-n_tab // cols), cols


def _dims(t: torch.Tensor, n: int) -> tuple:
    """t's first n sizes, padded with 1 (the extension rejects bad ranks)."""
    return (tuple(t.shape) + (1,) * n)[:n]


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
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    b, h, hd = _dims(q, 3)
    _, bs, kh, _ = _dims(k_blocks, 4)
    splits, cols = split_plan(_dims(block_tables, 2)[1], bs, b, kh, ops.num_sms(q.device))
    ws = torch.empty((splits, b, h, hd + 2) if splits > 1 else (0,),
                     dtype=torch.float32, device=q.device)
    out = load_extension().paged_attention(q, k_blocks, v_blocks, block_tables,
                                           context_lens, ws, cols)
    ops.count("paged_attention")
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
    if k_blocks.device.type != "cuda":
        raise ValueError(f"paged_decode_write: no kernel for device {k_blocks.device}")
    load_extension().paged_decode_write(k_blocks, v_blocks, new_k, new_v,
                                        block_ids, offsets)
    ops.count("paged_decode_write")
    return k_blocks, v_blocks
