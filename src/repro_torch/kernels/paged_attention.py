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

# csrc/paged_attention.cu's shared-memory layout of a split block
MAX_SMEM = 232448         # kMaxSmem: 227 KB, the most a block can have
MAX_STAGES = 8            # kMaxStages: the stages' mbarriers are always laid out
RING_BYTES = 24 * 1024    # kRingBytes: the K/V page ring's target size
MAX_GROUPS = 64           # kMaxGroups: q heads per kv head the kernel takes


def _align16(x: int) -> int:
    return (x + 15) & ~15


def split_smem(groups: int, head_dim: int, elt: int, block_size: int, cols: int) -> int:
    """Bytes of dynamic shared memory a split block of ``cols`` table
    columns takes: ``split_smem(...).total`` of the CUDA source (the
    stages' mbarriers, the split's table entries, per-head max and sum,
    q as f32, the scores, and a ring of ``ring_stages`` padded pages)."""
    tile = block_size * (head_dim * elt + 16)
    stages = max(2, min(MAX_STAGES, RING_BYTES // tile))
    off = _align16(MAX_STAGES * 8 + cols * 4)
    off = _align16(off + 2 * groups * 4) + groups * head_dim * 4
    off = _align16(off + groups * cols * block_size * 4)
    return off + stages * tile


def split_plan(n_tab: int, block_size: int, batch: int, kv_heads: int,
               num_sms: int, *, groups: int = 1, head_dim: int = 128,
               elt: int = 2) -> Tuple[int, int]:
    """(splits, cols): split s of each (lane, kv head) walks table columns
    [s * cols, (s + 1) * cols).  Enough splits that the grid of batch x
    kv_heads x splits holds at least ``SPLIT_BLOCKS_PER_SM`` blocks per SM, each
    split at least ``SPLIT_MIN_KEYS`` and at most ``SPLIT_MAX_KEYS`` keys
    (one page where a page holds more), no more columns than the table
    has, and few enough that a split block's shared memory
    (:func:`split_smem` for ``groups`` q heads per kv head, ``head_dim``
    and ``elt``-byte K/V) stays within ``MAX_SMEM``.  Reads shapes only,
    never the context lengths."""
    n_tab, bs = max(1, n_tab), max(1, block_size)
    want = -(-SPLIT_BLOCKS_PER_SM * num_sms // max(1, batch * kv_heads))
    cols = max(n_tab // want, -(-SPLIT_MIN_KEYS // bs))
    cols = max(1, min(cols, SPLIT_MAX_KEYS // bs, n_tab))
    while cols > 1 and split_smem(groups, head_dim, elt, bs, cols) > MAX_SMEM:
        cols -= 1
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
    valid lengths (pos + 1).  GQA via H == KH * groups, groups at most
    ``MAX_GROUPS``; scale 1/sqrt(hd).
    """
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_blocks, v_blocks, block_tables,
                                   context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    b, h, hd = _dims(q, 3)
    _, bs, kh, _ = _dims(k_blocks, 4)
    splits, cols = split_plan(_dims(block_tables, 2)[1], bs, b, kh, ops.num_sms(q.device),
                              groups=h // max(1, kh), head_dim=hd,
                              elt=k_blocks.element_size())
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
