"""Sparse weight-delta encode/apply (the low-latency-update hot path, §4.3).

Counterpart of ``repro.core.delta``.  The wire format is ``LayerDelta``
(indices + values, or chunk pages) from ``weightstore``; the receiving
side applies it to tensors on their own device:

* rows deltas go through ``kernels.ops.delta_apply`` (the Hopper scatter
  kernel on CUDA, its plain version on the CPU);
* chunk pages are contiguous runs, so each is one slice copy into the
  layer (``buf[a:b].copy_(page)``) — no scatter needed.

Nothing goes back to the host: the result stays on the buffer's device.
``shard_delta`` splits a packet by each host's flat-index range, so a
data-parallel host fetches only the bytes its shard needs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params, unflatten_like
from repro_torch.core.weightstore import (LayerDelta, UpdatePacket, as_float32,
                                          host_dtype, to_host, to_tensor)


def encode_delta(old_params: Any, new_params: Any) -> UpdatePacket:
    """Client-side / test helper: sparse diff of two parameter dicts."""
    old_flat = flatten_params(old_params)
    new_flat = flatten_params(new_params)
    packet = UpdatePacket(model="local", from_version=None, to_version=-1)
    for name, new in new_flat.items():
        new_host, dt = to_host(new)
        a = as_float32(new_host).reshape(-1)
        b = as_float32(to_host(old_flat[name])[0]).reshape(-1)
        idx = np.nonzero(a != b)[0]
        if idx.size == 0:
            continue
        packet.deltas.append(
            LayerDelta(layer=name, shape=tuple(new_host.shape), dtype=dt,
                       indices=idx.astype(np.int64), values=a[idx])
        )
    return packet


def delta_to_dense(delta: LayerDelta) -> np.ndarray:
    """Materialize a LayerDelta into a dense update-or-zero host buffer:
    chunk pages in the delta's dtype (bf16 as bits), rows in float32."""
    size = int(np.prod(delta.shape)) if delta.shape else 1
    if delta.chunks is not None:
        buf = np.zeros(size, dtype=host_dtype(delta.dtype))
        ce = delta.chunk_elems
        for ci, page in delta.iter_pages():
            buf[ci * ce : ci * ce + page.size] = page
    else:
        buf = np.zeros(size, dtype=np.float32)
        buf[delta.indices] = as_float32(delta.values)
    return buf.reshape(delta.shape)


def apply_delta(buf: torch.Tensor, d: LayerDelta, *, donate: bool = False) -> torch.Tensor:
    """One layer's delta applied to ``buf`` on its device.  ``donate=True``
    writes into ``buf`` itself; otherwise ``buf`` is untouched
    (copy-on-apply) and a new tensor of its shape comes back."""
    flat = buf.reshape(-1)
    if d.chunks is not None:
        out = flat if donate else flat.clone()
        ce = d.chunk_elems
        for ci, page in d.iter_pages():
            out[ci * ce : ci * ce + page.size].copy_(to_tensor(page, out.device))
    else:
        from repro_torch.kernels import ops

        out = ops.delta_apply(flat, to_tensor(d.indices, flat.device),
                              to_tensor(d.values, flat.device), donate=donate)
    return out.reshape(buf.shape)


def apply_packet(params: Any, packet: UpdatePacket, *, donate: bool = False) -> Any:
    """Apply an update packet to local params (edge-device side, §3.1.2).

    ``donate=True`` scatters into the given tensors in place (a staging
    copy the caller owns); otherwise ``params`` is untouched and each
    touched layer is copied once, the rest shared.  Several parts of one
    layer in a packet apply in order."""
    flat = flatten_params(params)
    out = dict(flat)
    copied = set()
    for d in packet.deltas:
        if d.layer not in flat:
            raise KeyError(f"delta for unknown layer {d.layer!r}")
        out[d.layer] = apply_delta(out[d.layer], d,
                                   donate=donate or d.layer in copied)
        copied.add(d.layer)
    return unflatten_like(params, out)


def shard_delta(packet: UpdatePacket, shard_ranges: Dict[str, Tuple[int, int]]) -> UpdatePacket:
    """Restrict a packet to one host's flat-index range per layer.

    ``shard_ranges[layer] = (start, stop)`` over the flattened tensor;
    layers absent from the map are shipped whole (replicated params).
    """
    out = UpdatePacket(model=packet.model, from_version=packet.from_version,
                       to_version=packet.to_version)
    for d in packet.deltas:
        rng = shard_ranges.get(d.layer)
        if rng is None:
            out.deltas.append(d)
            continue
        start, stop = rng
        if d.chunks is not None:
            ce = d.chunk_elems
            keep = [(i, c, f) for i, c, f in zip(d.indices, d.chunks,
                                                 d.chunk_flags())
                    if int(i) * ce < stop and (int(i) + 1) * ce > start]
            if not keep:
                continue
            out.deltas.append(LayerDelta(
                layer=d.layer, shape=d.shape, dtype=d.dtype,
                indices=np.array([i for i, _, _ in keep], dtype=np.int64),
                chunks=[c for _, c, _ in keep], chunk_elems=ce,
                chunk_compressed=[f for _, _, f in keep]))
        else:
            sel = (d.indices >= start) & (d.indices < stop)
            if not sel.any():
                continue
            out.deltas.append(LayerDelta(
                layer=d.layer, shape=d.shape, dtype=d.dtype,
                indices=d.indices[sel], values=d.values[sel]))
    return out
