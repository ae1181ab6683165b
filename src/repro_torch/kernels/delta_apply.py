"""Sparse weight-delta scatter on Hopper: ``delta_apply`` and its in-place
form (the low-latency update of §4.3).

Replaces the Pallas TPU kernels ``delta_apply`` / ``delta_apply_inplace``
of ``repro/kernels/delta_apply.py`` with hand-written CUDA C++
(``csrc/delta_apply.cu``, built by ``build.load_extension``): one thread
per delta entry stores its value at its flat index, instead of the TPU's
compare of every index against every tile.

* ``donate=False`` (``delta_apply``): the output is ``buf.clone()`` —
  the TPU kernel's pass-through of untouched entries, a byte copy — and
  the kernel scatters into it; ``buf`` is untouched (copy-on-apply, what
  the boot pull relies on).
* ``donate=True`` (``delta_apply_inplace``): the kernel scatters into
  ``buf`` itself, O(delta) bytes (the staged sync applies many bounded
  parts to one staging copy this way).

A CPU tensor takes the plain version (``ref.delta_apply``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_DTYPES = (torch.int32, torch.int64)


def delta_apply(buf: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
                *, donate: bool = False) -> torch.Tensor:
    """``buf[indices] = values`` on a flat (N,) buffer; returns the result.

    buf (N,) f32 or bf16; indices (n,) int32 or int64, unique, entries
    outside [0, N) dropped; values (n,) f32 or bf16, cast to buf's dtype
    (round to nearest even)."""
    if buf.device.type == "cpu":
        return ref.delta_apply(buf, indices, values, donate=donate)
    name = "delta_apply_inplace" if donate else "delta_apply"
    ops.require_cuda(name, buf.device, (("buf", buf), ("indices", indices),
                                        ("values", values)))
    if buf.ndim != 1 or indices.ndim != 1 or values.shape != indices.shape:
        raise ValueError(f"{name}: buf {tuple(buf.shape)} must be flat and "
                         f"indices {tuple(indices.shape)} / values "
                         f"{tuple(values.shape)} one-dimensional of one length")
    if buf.dtype not in _DTYPES or values.dtype not in _DTYPES:
        raise TypeError(f"{name}: buf/values dtypes {buf.dtype}/{values.dtype} "
                        f"not in {_DTYPES}")
    if indices.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{name}: indices dtype {indices.dtype} not in {_INDEX_DTYPES}")
    out = buf if donate else buf.clone()
    if indices.numel() == 0:
        return out
    from repro_torch.kernels.build import load_extension

    load_extension().delta_apply(out, indices, values)
    ops.count(name)
    return out
