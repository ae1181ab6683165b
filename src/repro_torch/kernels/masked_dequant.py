"""Fused int8 dequant + license-interval mask: a Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/masked_dequant.py::
masked_dequant``.  One elementwise pass builds a licensed weight tile:
read the int8 codes once, multiply by the per-column / per-row / scalar
f32 scale, zero every weight whose magnitude falls in any of the
``MAX_INTERVALS`` license intervals (lo == hi slots are inert), cast to
the output dtype and write once.  The arithmetic is f32 and the cast
comes last, as in the TPU kernel, so the result is bit-identical to the
plain version in ``ref.py``.

What bounds it: bytes.  Per element it reads 1 byte and writes 2 (bf16)
or 4 (f32) with ~20 flops, far below the card's flop-per-byte ridge, so
the only lever is streaming at full bandwidth; Triton's masked block
loads do that as well as hand-written CUDA would, and mask the ragged
edge of any (R, C), so no padding copy is made.

Triton is imported inside the launcher: the CPU machines that run the
tests have no Triton, and a CPU tensor takes the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import MAX_INTERVALS

BLOCK_R = 32
BLOCK_C = 256


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    from repro_torch.kernels.build import triton_env

    triton_env()
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(codes_ptr, scale_ptr, lo_ptr, hi_ptr, out_ptr, R, C,
               scale_sr, scale_sc, N_IV: tl.constexpr,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        inb = (rows[:, None] < R) & (cols[None, :] < C)
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        codes = tl.load(codes_ptr + offs, mask=inb, other=0)
        scale = tl.load(scale_ptr + rows[:, None] * scale_sr
                        + cols[None, :] * scale_sc, mask=inb, other=0.0)
        w = codes.to(tl.float32) * scale
        mag = tl.abs(w)
        dead = (mag >= tl.load(lo_ptr)) & (mag < tl.load(hi_ptr))
        for i in tl.static_range(1, N_IV):
            dead = dead | ((mag >= tl.load(lo_ptr + i))
                           & (mag < tl.load(hi_ptr + i)))
        out = tl.where(dead, 0.0, w)
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=inb)

    return triton, kernel


def masked_dequant(codes: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, *, out_dtype=torch.float32) -> torch.Tensor:
    """codes (R, C) int8; scale (1, C), (R, 1) or (1, 1) f32; lo/hi
    (MAX_INTERVALS,) f32.  Returns (R, C) licensed weights in
    ``out_dtype`` (f32 or bf16).

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel, and anything the kernel does not take raises."""
    if codes.device.type == "cpu":
        return ref.masked_dequant(codes, scale, lo, hi, out_dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"masked_dequant: no kernel for device {codes.device}")
    r, c = codes.shape
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if lo.shape != (MAX_INTERVALS,) or hi.shape != (MAX_INTERVALS,):
        raise ValueError(f"lo/hi must be ({MAX_INTERVALS},), got "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    if scale.shape == (1, c):
        strides = (0, 1)
    elif scale.shape == (r, 1):
        strides = (1, 0)
    elif scale.shape == (1, 1):
        strides = (0, 0)
    else:
        raise ValueError(f"scale shape {tuple(scale.shape)} not broadcastable "
                         f"to {(r, c)}")
    for name, t in (("scale", scale), ("lo", lo), ("hi", hi)):
        if t.device != codes.device:
            raise ValueError(f"{name} on {t.device}, codes on {codes.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    codes = codes.contiguous()
    scale = scale.contiguous()
    out = torch.empty((r, c), dtype=out_dtype, device=codes.device)
    triton, kernel = _triton_kernel()
    grid = (triton.cdiv(r, BLOCK_R), triton.cdiv(c, BLOCK_C))
    kernel[grid](codes, scale, lo.contiguous(), hi.contiguous(), out, r, c,
                 strides[0], strides[1], N_IV=MAX_INTERVALS,
                 BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4)
    ops.LAUNCHES["masked_dequant"] += 1
    return out
