"""The int8-weight matrix product on Hopper: ``quant_matmul``.

Replaces the Pallas TPU kernel ``quant_matmul``
(``repro/kernels/quant_matmul.py:40``) with hand-written CUDA C++
(``csrc/quant_matmul.cu``, built by ``build.load_extension``):
``x (M, K) @ (codes (K, N) int8 * scale (N,))`` with ONE f32 accumulator
over all of K and one cast to the output dtype, as the oracle does (the
TPU kernel rounds each K block's partial into a bf16 output).  The
kernel takes any M, K and N and masks the edges, so nothing is padded.

What bounds it on the card: bytes at a decode step's M (the codes are
read once; 22.5 MB for one 2048 x 11008 MLP matrix of qwen2.5-3b) and
operations at a prefill's M (1.85e11 flop at M = 4096).  bf16 x goes to
the tensor cores with the codes staged as bf16 (exact); f32 x is split
into three bf16 terms, so every product is exact and no TF32 is used.

``ops.quant_matmul`` is the public dispatcher (leading dimensions,
default ``out_dtype``); this module is its 2-D kernel wrapper.  A CPU
tensor takes the plain version (``ref.quant_matmul``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import _require_cuda

_X_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """x (M, K) f32 or bf16 @ (codes (K, N) int8 * scale (N,) f32) ->
    (M, N) in ``out_dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return ref.quant_matmul(x, codes, scale, out_dtype)
    _require_cuda("quant_matmul", x.device,
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
    m, n = x.shape[0], codes.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"quant_matmul: M={m} exceeds the grid's 65535 row tiles")
    if m == 0 or n == 0:
        return torch.empty(m, n, dtype=out_dtype, device=x.device)
    from repro_torch.kernels.build import load_extension

    out = load_extension().quant_matmul(x, codes, scale, out_dtype == torch.bfloat16)
    ops.LAUNCHES["quant_matmul"] += 1
    return out
