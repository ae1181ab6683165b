"""Fused int8 dequant + license-interval mask on Hopper, one launch per leaf.

Replaces the Pallas TPU kernel ``repro/kernels/masked_dequant.py::
masked_dequant`` with hand-written CUDA C++ (``csrc/masked_dequant.cu``,
built by ``build.load_extension``; shapes and dtypes are checked in
``csrc/bindings.cpp``).  One elementwise pass builds a licensed weight
tensor: read the int8 codes once, multiply by the f32 scale (per column,
per row or a scalar), zero every weight whose magnitude falls in any of
the ``MAX_INTERVALS`` license intervals (lo >= hi slots are inert), cast
to the output dtype and write once.  The arithmetic is f32 and the cast
comes last, as in the TPU kernel, so the result is bit-identical to the
plain version in ``ref.py``.

Unlike the TPU kernel, which took one (R, C) slice, the kernel takes a
whole stacked leaf (U, R, C) with a scale whose leading axis is U or 1,
so a licensed view costs one launch per leaf and no stacking copy.  What
bounds it is bytes (1 read and 2 or 4 written per element); the kernel's
source says how it streams them.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops, ref


def masked_dequant(codes: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, *, out_dtype=torch.float32) -> torch.Tensor:
    """codes (R, C) or (U, R, C) int8; scale f32 of the same rank, per
    column (.., 1, C), per row (.., R, 1) or scalar (.., 1, 1), with a
    leading axis of U or 1; lo/hi (MAX_INTERVALS,) f32 on codes' device
    (``ops.pack_intervals``).  Returns the licensed weights in codes'
    shape and ``out_dtype`` (f32 or bf16).

    CPU tensors take the plain version, and so do ``meta`` tensors
    (shapes only: the launch tools' dry run); CUDA tensors launch the
    kernel, and anything the kernel does not take raises.  A ``DTensor``
    raises: a leaf on a mesh reaches the kernel shard by shard, through
    ``local_map`` (``serving/quantized.py``)."""
    if isinstance(codes, DTensor) or isinstance(scale, DTensor):
        raise TypeError("masked_dequant takes local tensors: dequantize a DTensor leaf "
                        "through local_map (serving.quantized.dequant_leaf)")
    if codes.device.type in ("cpu", "meta"):
        return ref.masked_dequant(codes, scale, lo, hi, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_dequant: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    from repro_torch.kernels.build import load_extension

    out = load_extension().masked_dequant(codes.contiguous(), scale.contiguous(), lo, hi,
                                          out_dtype == torch.bfloat16)
    if out.numel():
        ops.count("masked_dequant")
    return out
