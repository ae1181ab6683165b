"""Model-compression pipeline (paper §3.2, Fig. 3) on torch tensors.

prune -> (fine-tune, done by the caller's training loop) -> quantize ->
weight-share.  Counterpart of ``repro.core.compression``: every step runs
on the tensor's own device, and ``prune_params`` / ``compress_pipeline``
return tensors on the weights' device (the JAX version returns host
arrays).

Numerics follow the JAX package:

* ``magnitude_threshold`` is ``jnp.quantile``'s arithmetic: the rank
  ``q * (n - 1)`` and the lerp ``lo * (1 - t) + hi * t`` in float32 (the
  second product fused into the add, as XLA's CPU backend emits it), the
  two order statistics from a count of bit patterns (16-bit weights, no
  sort and no 2^24-element limit) or a sort; ``|w| >= thr`` compares in
  float32, as ``jnp.abs(w) >= thr`` promotes a 16-bit ``w``;
* ``quantize_int8`` divides in float32 (by device tensors, the same
  division on the card and the CPU) and rounds half to even, one
  scale per slice of axis 0 (per unit on a stacked ``(U, in, out)``
  leaf);
* ``kmeans_1d`` starts from the same linear codebook and breaks argmin
  ties to the first centroid; its sums run in another order than
  ``segment_sum``'s, so centroids agree at float32 tolerance.

Large leaves are processed in slices of axis 0 of at most ``_CHUNK``
elements, so no full-size float32 temporary is made.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params, unflatten

# Parameters whose magnitude encodes recurrence *dynamics* rather than a
# linear map.  Pruning/masking these can make an SSM non-contractive —
# every compression / licensing entry point excludes them.
DYNAMICS_PARAM_KEYWORDS = ("A_log", "dt_bias", "a_param", "norm", "scale", "bias_embed")

_CHUNK = 1 << 26          # elements per slice of a large leaf
_ASSIGN_ROWS = 1 << 21    # values per k-means assignment: (rows, k) distances


def is_dynamics_param(name: str) -> bool:
    return any(k in name for k in DYNAMICS_PARAM_KEYWORDS)


def row_slices(t: torch.Tensor) -> Iterator[Any]:
    """Slices of axis 0 holding at most ``_CHUNK`` elements (one row at
    least); a 0-d tensor is one slice, ``...``."""
    if t.ndim == 0:
        yield ...
        return
    rows = max(1, _CHUNK // max(1, t[0].numel()))
    for s in range(0, t.shape[0], rows):
        yield slice(s, s + rows)


# ------------------------------------------------------------------- pruning
def magnitude_threshold(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """|w| value below which ``sparsity`` fraction of entries fall: a 0-d
    float32 tensor on ``w``'s device, ``jnp.quantile(|w|, sparsity)``
    bit for bit."""
    from repro_torch.core.licensing import _order_stats_16bit, _order_stats_sorted

    f32 = np.float32
    n = w.numel()
    n1 = f32(n) - f32(1)                    # rounds in f32 past 2^24
    rank = f32(sparsity) * n1
    low, high = np.floor(rank), np.ceil(rank)
    t_hi = rank - low
    t_lo = f32(1) - t_hi
    # clamped to n - 1 as a float, then (as XLA's gather does) to the last index
    ks = np.array([min(int(min(max(x, 0), n1)), n - 1) for x in (low, high)])
    lo_v, hi_v = map(f32, (_order_stats_16bit if w.element_size() == 2
                           and w.dtype.is_floating_point else _order_stats_sorted)([w], ks))
    # lo*(1-t) + hi*t with the second product fused into the add, as XLA's
    # CPU backend emits it (the f32 product is exact in f64)
    thr = f32(np.float64(hi_v) * np.float64(t_hi) + np.float64(f32(lo_v * t_lo)))
    return torch.tensor(thr, dtype=torch.float32, device=w.device)


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Magnitude pruning [Han et al. 2016]: zero the smallest-|w| fraction."""
    thr = magnitude_threshold(w, sparsity)
    w = w.detach()
    out = torch.empty_like(w)
    for s in row_slices(w):
        # |w| >= thr compared in f32, as JAX promotes a 16-bit |w|
        out[s] = torch.where(w[s].abs().float() >= thr, w[s], 0)
    return out


def prune_params(params: Any, sparsity: float, *,
                 exclude: Callable[[str], bool] = is_dynamics_param) -> Any:
    """Per-layer magnitude pruning over a parameter dict, skipping
    dynamics params and 1-D leaves (those are shared by reference)."""
    out = {}
    for name, arr in flatten_params(params).items():
        if exclude(name) or arr.ndim < 2:
            out[name] = arr
        else:
            out[name] = magnitude_prune(arr, sparsity)
    return unflatten(out)


# -------------------------------------------------------------- quantization
@dataclass(frozen=True)
class QuantizedTensor:
    """Symmetric int8 quantization with per-channel (axis 0 of the flattened
    2D view) scales — §3.2 "converting weights from 64-bit to 8-bit"."""

    codes: torch.Tensor     # int8, same shape as the original
    scale: torch.Tensor     # f32, broadcastable to codes
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) + int(np.prod(tuple(self.scale.shape))) * 4


def quantize_int8(w: torch.Tensor, *, per_channel: bool = True) -> QuantizedTensor:
    w = w.detach()
    if per_channel and w.ndim >= 2:
        # the max of |w| is exact in w's dtype; one scale per row of axis 0
        amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True).float()
    else:
        amax = w.abs().max().float()
    # a device tensor divisor: CUDA divides by a host scalar as a product
    # with its reciprocal, which can round differently
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for s in row_slices(w):
        sc = scale[s] if scale.ndim else scale
        codes[s] = torch.round(w[s].float() / sc).clamp_(-127, 127).to(torch.int8)
    return QuantizedTensor(codes=codes, scale=scale, shape=tuple(w.shape), dtype=w.dtype)


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    return (q.codes.float() * q.scale).to(q.dtype)


# ------------------------------------------------------------ weight sharing
@dataclass(frozen=True)
class SharedTensor:
    """Weight sharing [Deep Compression]: k-means codebook + per-entry index."""

    codebook: torch.Tensor  # (k,) f32
    indices: torch.Tensor   # uint8, same shape as original
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        # index matrix at ceil(log2 k) bits + codebook
        k = int(self.codebook.shape[0])
        bits = max(1, int(np.ceil(np.log2(max(k, 2)))))
        return int(np.prod(self.shape)) * bits // 8 + k * 4


def _assign(flat: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every value (the first on a tie), a slice of
    ``_ASSIGN_ROWS`` values at a time."""
    out = torch.empty(flat.shape, dtype=torch.int64, device=flat.device)
    for s in range(0, flat.numel(), _ASSIGN_ROWS):
        part = flat[s:s + _ASSIGN_ROWS]
        out[s:s + _ASSIGN_ROWS] = (part[:, None] - centroids[None, :]).abs().argmin(1)
    return out


def kmeans_1d(x: torch.Tensor, k: int, iters: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D k-means by Lloyd iterations.

    Initialization is linear over [min, max] (Deep Compression's recommended
    linear init).  Empty clusters keep their previous centroid.
    """
    flat = x.detach().reshape(-1).float()
    lo, hi = flat.min(), flat.max()
    steps = torch.arange(k, dtype=torch.float32, device=flat.device) + 0.5
    centroids = lo + (hi - lo) * steps / flat.new_tensor(k)
    for _ in range(iters):
        a = _assign(flat, centroids)
        sums = torch.zeros(k, dtype=torch.float32, device=flat.device).index_add_(0, a, flat)
        counts = torch.bincount(a, minlength=k).float()
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1.0), centroids)
    return centroids, _assign(flat, centroids).to(torch.uint8)


def weight_share(w: torch.Tensor, k: int = 32, iters: int = 25) -> SharedTensor:
    codebook, idx = kmeans_1d(w, k, iters)
    return SharedTensor(codebook=codebook, indices=idx.reshape(w.shape),
                        shape=tuple(w.shape), dtype=w.dtype)


def unshare(s: SharedTensor) -> torch.Tensor:
    return s.codebook[s.indices.long()].to(s.dtype)


# ---------------------------------------------------------------- pipeline
@dataclass
class CompressionStats:
    full_bytes: int
    pruned_nonzero: int
    pruned_bytes: int          # sparse: 8B index + value bytes per nonzero
    quantized_bytes: int       # sparse int8: 8B index + 1B code (+ scales)
    shared_bytes: int          # sparse shared: index + log2(k)-bit code
    sparsity: float


def compress_pipeline(
    params: Any,
    *,
    sparsity: float = 0.8,
    codebook_size: Optional[int] = 32,
    value_bytes_full: int = 8,   # the paper's pre-quant baseline is 64-bit
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[Any, Dict[str, QuantizedTensor], CompressionStats]:
    """Fig. 3 pipeline: prune -> quantize -> share.  Returns the pruned
    (dense, zeros in place) params for fine-tuning, the quantized per-layer
    tensors for storage/serving, and Table-1-style accounting.

    ``timings``, when given, receives the seconds of the three passes
    ("prune", "quantize", "stats"), each ended by a device synchronize."""
    def lap(key, t0):
        if timings is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            timings[key] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    pruned = prune_params(params, sparsity)
    flat = flatten_params(pruned)
    t0 = lap("prune", t0)
    quantized: Dict[str, QuantizedTensor] = {name: quantize_int8(arr)
                                             for name, arr in flat.items()}
    t0 = lap("quantize", t0)
    nz = torch.stack([torch.count_nonzero(a).to("cpu") for a in flat.values()]).tolist()
    total = int(sum(a.numel() for a in flat.values()))
    nonzero = int(sum(nz))
    shared_bytes = 0
    for count in nz:
        if codebook_size:
            bits = max(1, int(np.ceil(np.log2(max(codebook_size, 2)))))
            shared_bytes += count * (8 + bits / 8) + codebook_size * 4
        else:
            shared_bytes += count * 9

    stats = CompressionStats(
        full_bytes=total * value_bytes_full,
        pruned_nonzero=nonzero,
        pruned_bytes=nonzero * (8 + value_bytes_full),
        quantized_bytes=nonzero * 9 + sum(math.prod(q.scale.shape) * 4
                                          for q in quantized.values()),
        shared_bytes=int(shared_bytes),
        sparsity=1.0 - nonzero / max(total, 1),
    )
    lap("stats", t0)
    return pruned, quantized, stats
