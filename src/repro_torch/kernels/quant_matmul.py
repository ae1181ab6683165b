"""The int8-weight matrix product on Hopper: ``quant_matmul``.

Replaces the Pallas TPU kernel ``quant_matmul``
(``repro/kernels/quant_matmul.py:40``) with hand-written CUDA C++, built
by ``build.load_extension``: ``x (M, K) @ (codes (K, N) int8 * scale
(N,))`` with the scale taken out of the sum and applied once, f32
accumulation and one cast to the output dtype, as the oracle does (the
TPU kernel rounds each K block's partial into a bf16 output).  The
kernels take any M, K and N and mask the edges, so nothing is padded.

What bounds it on the card: bytes at a decode step's M (the codes are
read once; 22.5 MB for one 2048 x 11008 MLP matrix of qwen2.5-3b) and
operations at a prefill's M (1.85e11 flop at M = 4096).  Three designs,
picked by x's dtype and M (``design``); none uses TF32:

* bf16 x, M <= ``SMALL_M``: ``"splitk"`` (``csrc/quant_matmul_sm90.cu``)
  streams the codes once as the A operand of ``mma.sync`` (out^T =
  codes^T . x^T), split over K by ``splitk_plan`` into an f32 workspace
  allocated here, then adds the slices in a fixed order, scales and casts.
* bf16 x, larger M: ``"wgmma"`` (same file), 128 x 128 tiles on
  warpgroup products, the codes converted to bf16 in shared memory while
  the previous chunk's products run.
* f32 x: ``"mma_sync"`` (``csrc/quant_matmul.cu``), x split into three
  exact bf16 terms so every product is exact.

Times on the H100 are in PERF.md.  ``ops.quant_matmul`` is the public
dispatcher (leading dimensions, default ``out_dtype``); this module is
its 2-D kernel wrapper, and one call is one count in ``ops.LAUNCHES``
(the split-K reduction is part of the call).  A CPU tensor takes the
plain version (``ref.quant_matmul``); a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops, ref

_X_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)

SMALL_M = 32          # bf16 x with M up to this takes the split-K design
SPLITK_BN = 128       # columns per split-K block
SPLITK_BK = 64        # k rows per stage of its ring: slices are multiples of this
SPLITK_BLOCKS_PER_SM = 4


def design(x_dtype: torch.dtype, m: int) -> str:
    """The kernel a CUDA call takes: ``"splitk"``, ``"wgmma"`` or ``"mma_sync"``."""
    if x_dtype != torch.bfloat16:
        return "mma_sync"
    return "splitk" if m <= SMALL_M else "wgmma"


def splitk_plan(k: int, n: int, num_sms: int) -> Tuple[int, int]:
    """(slices, slice_k) of the split-K design: enough K slices that the
    grid of (N / 128 column tiles) x slices holds ``SPLITK_BLOCKS_PER_SM``
    blocks per SM where K has that many 64-row chunks, each slice a
    multiple of 64 rows and none empty.  Slice s covers rows
    [s * slice_k, min(K, (s + 1) * slice_k))."""
    n_tiles = -(-n // SPLITK_BN)
    chunks = max(1, -(-k // SPLITK_BK))
    want = -(-SPLITK_BLOCKS_PER_SM * num_sms // n_tiles)
    slice_k = max(1, chunks // want) * SPLITK_BK
    return max(1, -(-k // slice_k)), slice_k


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """x (M, K) f32 or bf16 @ (codes (K, N) int8 * scale (N,) f32) ->
    (M, N) in ``out_dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return ref.quant_matmul(x, codes, scale, out_dtype)
    ops.require_cuda("quant_matmul", x.device,
                     (("x", x), ("codes", codes), ("scale", scale)))
    if x.ndim != 2 or codes.ndim != 2 or x.shape[1] != codes.shape[0] \
            or scale.shape != (codes.shape[1],):
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, codes {tuple(codes.shape)}, "
                         f"scale {tuple(scale.shape)} (need (M, K), (K, N), (N,))")
    if x.dtype not in _X_DTYPES or codes.dtype != torch.int8 \
            or scale.dtype != torch.float32 or out_dtype not in _OUT_DTYPES:
        raise TypeError(f"quant_matmul: x {x.dtype} (of {_X_DTYPES}), codes "
                        f"{codes.dtype} (int8), scale {scale.dtype} (f32), out "
                        f"{out_dtype} (of {_OUT_DTYPES})")
    m, k = x.shape
    n = codes.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"quant_matmul: M={m} exceeds the grid's 65535 row tiles")
    if m == 0 or n == 0:
        return torch.empty(m, n, dtype=out_dtype, device=x.device)
    from repro_torch.kernels.build import load_extension

    ext = load_extension()
    out_bf16 = out_dtype == torch.bfloat16
    kind = design(x.dtype, m)
    if kind == "splitk":
        slices, slice_k = splitk_plan(k, n, ops.num_sms(x.device))
        ws = torch.empty(slices, m, n, dtype=torch.float32, device=x.device)
        out = ext.quant_matmul_splitk(x, codes, scale, ws, slice_k, out_bf16)
    elif kind == "wgmma":
        out = ext.quant_matmul_sm90(x, codes, scale, out_bf16)
    else:
        out = ext.quant_matmul(x, codes, scale, out_bf16)
    ops.count("quant_matmul")
    return out
