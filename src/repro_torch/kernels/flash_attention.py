"""Prefill attention on Hopper: ``flash_attention``.

Replaces the Pallas TPU kernel ``flash_attention``
(``repro/kernels/flash_attention.py:84``) with hand-written CUDA C++,
built by ``build.load_extension``: causal, windowed and offset
online-softmax attention with GQA, whose scores never leave the chip.
The layout is the JAX function's, q ``(BH, Sq, hd)`` and k/v
``(BKH, Sk, hd)`` with ``BH == BKH * groups`` (q head ``bh`` reads kv
head ``bh // groups``); the output is f32 whatever the input dtype.
Unlike the TPU kernel it takes any Sq and Sk (the kernels mask the
ragged edge) and has no block-size or ``interpret`` arguments.

What bounds it on the card: operations (4 * hd flop per unmasked (q, k)
pair against a few bytes per row).  Two designs, picked by dtype and head
dim (``design``):

* bf16 inputs with hd 64 or 128 (qwen2.5-3b's prefill): ``wgmma``
  (``csrc/flash_attention_sm90.cu``): 128 q rows per block over two
  warpgroups, 128-key K/V tiles through a 3-stage ``cp.async`` ring, S
  and P.V as warpgroup products, p carried as two bf16 terms.
* f32 inputs, and hd 32: ``mma.sync`` (``csrc/flash_attention.cu``),
  with f32 inputs split into two bf16 terms (no TF32).

Both skip the k tiles that the causal or window mask removes entirely and
keep every score in registers.  Times on the H100 are in PERF.md.

No path of either package calls it (the prefill keeps its own attention,
as the JAX prefill keeps ``attention_core``); this function is the entry
point.  A CPU tensor takes the plain version (``ref.flash_attention``); a
CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

_HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_WGMMA_HEAD_DIMS = (64, 128)


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 at hd 64 / 128,
    else ``"mma_sync"``."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS else "mma_sync"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    groups: int = 1) -> torch.Tensor:
    """Online-softmax attention; returns (BH, Sq, hd) f32.

    q (BH, Sq, hd); k/v (BKH, Sk, hd) of q's dtype (f32 or bf16), BH ==
    BKH * groups.  Query row i sits at position ``q_offset + i``; key j
    is masked where ``j > pos`` (``causal``) or ``j <= pos - window``
    (``window != 0``); a row with no valid key is 0.  Scale 1/sqrt(hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, groups=groups)
    ops.require_cuda("flash_attention", q.device, (("q", q), ("k", k), ("v", v)))
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be (BH, Sq, hd) "
                         f"and k/v {tuple(k.shape)}/{tuple(v.shape)} one (BKH, Sk, hd)")
    bh, sq, hd = q.shape
    bkh, _, hd_k = k.shape
    if hd_k != hd or bh != bkh * groups or groups < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k/v {tuple(k.shape)} "
                         f"with groups={groups} (need BH == BKH * groups, one hd)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share one dtype of {_DTYPES}, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {_HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"flash_attention: {bh} q heads exceed the grid's 65535")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {label} is not 16-byte aligned")
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    from repro_torch.kernels.build import load_extension

    ext = load_extension()
    kernel = ext.flash_attention_sm90 if design(q.dtype, hd) == "wgmma" else ext.flash_attention
    out = kernel(q, k, v, bool(causal), int(window), int(q_offset), int(groups))
    ops.count("flash_attention")
    return out
