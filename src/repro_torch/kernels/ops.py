"""Public kernel entry points of the port and their launch counters.

``LAUNCHES`` counts kernel launches per kernel name: each wrapper adds
one exactly where it launches its CUDA kernel (``count``; never on the
CPU path, and never while a CUDA graph is being captured, which records
the kernel without launching it), so a run can prove that its main path
went through the kernels.  A graph's replays run no wrapper: what they
launch is read from the device trace.
``masked_dequant`` here is the dispatcher for a list of intervals:
unlike the JAX package's (which sends shapes under 256x256 to the
oracle), the CUDA path has no small-shape shortcut — the kernel takes
any shape.  The licensed views pack a tier's intervals once per view and
call ``kernels.masked_dequant`` per stacked leaf instead.  The same holds
for ``quant_matmul`` (the JAX dispatcher pads to block multiples and sends
products under 128^3 to the oracle) and ``delta_apply``.
``flash_attention`` has no dispatcher: its entry point is
``kernels.flash_attention.flash_attention``.  ``require_cuda`` and
``num_sms`` are the checks and the SM count the CUDA wrappers share.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MAX_INTERVALS = 8

LAUNCHES: Dict[str, int] = {"paged_attention": 0, "paged_decode_write": 0,
                            "masked_dequant": 0, "delta_apply": 0,
                            "delta_apply_inplace": 0, "flash_attention": 0,
                            "quant_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    """Count one launch of kernel ``name`` on the card: its wrapper calls
    this where it launches.  Under CUDA-graph capture nothing launches, so
    nothing is counted."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def require_cuda(name: str, device: torch.device, tensors) -> None:
    """Raise ValueError unless ``device`` is a CUDA device and every
    (label, tensor) of ``tensors`` lies on it, contiguous."""
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for label, t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {label} on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device (the split plans size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_intervals(intervals: Sequence[Tuple[float, float]],
                   device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a license tier's interval list to (MAX_INTERVALS,) f32 lo/hi;
    padding slots have lo == hi == 0 and are inert.  Both are rows of one
    (2, MAX_INTERVALS) tensor: one host-to-device copy per call."""
    ivs = list(intervals)[:MAX_INTERVALS]
    packed = np.zeros((2, MAX_INTERVALS), np.float32)
    for i, (a, b) in enumerate(ivs):
        packed[0, i], packed[1, i] = a, b
    both = torch.from_numpy(packed).to(device)
    return both[0], both[1]


def masked_dequant(codes: torch.Tensor, scale: torch.Tensor,
                   intervals: Sequence[Tuple[float, float]] = (), *,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Licensed weights from int8 codes in one fused pass (paper §3.5).

    ``scale`` is per column ((C,) or (1, C)), per row ((R, 1)) or a scalar
    ((1, 1)), as in ``repro.kernels.ops.masked_dequant``; 3-D codes take
    the scale forms of ``kernels.masked_dequant``.  Packs ``intervals``
    on every call (one host-to-device copy on the card)."""
    from repro_torch.kernels.masked_dequant import masked_dequant as _kernel

    c = codes.shape[-1]
    if scale.ndim == 1:
        scale = scale.reshape(1, -1) if scale.numel() == c else scale.reshape(-1, 1)
    lo, hi = pack_intervals(intervals, codes.device)
    return _kernel(codes, scale, lo, hi, out_dtype=out_dtype)


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """Activation (..., K) x int8 weights (K, N) with per-column scales
    (N,) -> (..., N), as ``repro.kernels.ops.quant_matmul``: ``out_dtype``
    defaults to x's dtype, leading dimensions are flattened and restored.
    One f32 accumulator over all of K and one cast at the end."""
    from repro_torch.kernels.quant_matmul import quant_matmul as _kernel

    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    out = _kernel(x.reshape(-1, x.shape[-1]), codes, scale, out_dtype=out_dtype)
    return out.reshape(*lead, codes.shape[-1])


# ``buf[indices] = values`` via the scatter kernel, as
# ``repro.kernels.ops.delta_apply`` (``donate=True`` lands in place).
# Unlike the JAX dispatcher there is no padding and no small-shape
# shortcut: the kernel takes any N and any number of entries.  Imported
# last because the wrapper counts into ``LAUNCHES`` above.
from repro_torch.kernels.delta_apply import delta_apply  # noqa: E402
