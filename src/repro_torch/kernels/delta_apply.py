"""Sparse weight-delta scatter on Hopper: ``delta_apply``, its in-place
form and the staged sync's one apply per step (the low-latency update of
§4.3).

Replaces the Pallas TPU kernels ``delta_apply`` / ``delta_apply_inplace``
of ``repro/kernels/delta_apply.py`` with hand-written CUDA C++
(``csrc/delta_apply.cu``, built by ``build.load_extension``): one thread
per delta entry stores its value at its flat index, instead of the TPU's
compare of every index against every tile.

* ``donate=False`` (``delta_apply``): the output is ``buf.clone()`` —
  the TPU kernel's pass-through of untouched entries, a byte copy — and
  the scatter kernel writes into it; ``buf`` is untouched
  (copy-on-apply, what the boot pull relies on).
* ``donate=True`` (``delta_apply_inplace``): the parts kernel with one
  rows segment writes into ``buf`` itself, O(delta) bytes.
* ``delta_apply_parts``: every part of one STAGE step of the staged sync
  (rows parts as :class:`Rows`, chunk pages as :class:`Run`) in ONE
  launch of the parts kernel.  The host packs the step (segment table,
  tile map, payload; :func:`plan_step` / :func:`write_step`) into a
  pinned slot of a :class:`StepRing` straight from the wire's bytes, and
  one asynchronous copy brings it to the card.  This is also what the JAX
  stager does around its kernel: the scatter per rows part and the
  donated ``dynamic_update_slice`` per page.  Launches count under
  ``delta_apply_inplace``, the TPU kernel the parts kernel replaces.

A CPU tensor takes the plain version (``ref.delta_apply``,
``ref.delta_apply_parts``); a CUDA tensor launches the kernel or raises.
``ref.delta_apply_packed`` applies a packed step as the kernel reads it,
so the CPU tests hold the layout too.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import ops, ref

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_DTYPES = (torch.int32, torch.int64)

# the packed step, as csrc/delta_apply.cu reads it: a table of SEGMENT_WORDS
# int64 words a segment at byte 0, the tile -> segment map (int32) and the
# payload, each section and each payload array 16-byte aligned
SEGMENT_WORDS = 8
ROWS, RUN = 0, 1
DST_BF16, VAL_BF16, IDX32 = 1, 2, 4
TILE_ROWS = 1024          # rows entries a tile (256 threads x 4)
TILE_BYTES = 16384        # run bytes a tile (256 threads x 4 x 16 B)
ALIGN = 16


class Rows(NamedTuple):
    """A rows part: ``dst[indices] = values`` in place (the TPU kernel's
    aliased scatter).  Entries outside ``[0, N)`` are dropped; values are
    cast to dst's dtype (round to nearest even)."""

    dst: torch.Tensor        # flat (N,) f32 or bf16
    indices: np.ndarray      # (n,) int64 or int32, unique
    values: np.ndarray       # (n,) f32, or bf16 as np.uint16 bits


class Run(NamedTuple):
    """A contiguous run (a chunk page): ``dst[offset:offset + n] = data``."""

    dst: torch.Tensor        # flat (N,), any dtype
    offset: int              # the first element written
    data: np.ndarray         # (n,) in dst's dtype (bf16 as np.uint16 bits)


Segment = Union[Rows, Run]


class StepPlan(NamedTuple):
    """Where everything of one packed step goes (byte offsets)."""

    nbytes: int              # the whole packed buffer
    n_tiles: int
    map_off: int
    payload_off: int
    table: np.ndarray        # (segments, SEGMENT_WORDS) int64
    tile_seg: np.ndarray     # (n_tiles,) int32
    pieces: List[tuple]      # (offset from the payload base, flat array)


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def plan_step(segments: Sequence[Segment]) -> StepPlan:
    """Lay out one step's segments; empty ones take no table entry.  Raises
    on a destination or payload the kernel does not take."""
    rows: List[List[int]] = []
    pieces: List[tuple] = []
    tiles: List[int] = []
    pay = first_tile = 0
    for s in segments:
        if s.dst.ndim != 1 or not s.dst.is_contiguous():
            raise ValueError(f"delta_apply_parts: destination {tuple(s.dst.shape)} must be "
                             f"flat and contiguous")
        if isinstance(s, Rows):
            idx = np.ascontiguousarray(s.indices)
            val = np.ascontiguousarray(s.values)
            if idx.size == 0:
                continue
            if s.dst.dtype not in _DTYPES:
                raise TypeError(f"delta_apply_parts: rows into {s.dst.dtype}, not one of "
                                f"{_DTYPES}")
            if idx.dtype not in (np.int64, np.int32) or idx.ndim != 1:
                raise TypeError(f"delta_apply_parts: indices {idx.dtype} {idx.shape} must "
                                f"be (n,) int64 or int32")
            if val.dtype not in (np.float32, np.uint16) or val.shape != idx.shape:
                raise TypeError(f"delta_apply_parts: values {val.dtype} {val.shape} must be "
                                f"(n,) float32 or bf16 bits (uint16) beside {idx.shape}")
            idx_off = pay
            val_off = pay = _align(pay + idx.nbytes)
            pay = _align(pay + val.nbytes)
            pieces += [(idx_off, idx), (val_off, val)]
            flags = ((DST_BF16 if s.dst.dtype == torch.bfloat16 else 0)
                     | (VAL_BF16 if val.dtype == np.uint16 else 0)
                     | (IDX32 if idx.dtype == np.int32 else 0))
            count, offset, kind = idx.size, 0, ROWS
            n_tiles = -(-count // TILE_ROWS)
        else:
            data = np.ascontiguousarray(s.data).reshape(-1)
            if data.size == 0:
                continue
            esize = s.dst.element_size()
            if data.dtype.itemsize != esize:
                raise TypeError(f"delta_apply_parts: a run of {data.dtype} into "
                                f"{s.dst.dtype}: its bytes must be in the destination dtype")
            count, offset = data.size, int(s.offset)
            if offset < 0 or offset + count > s.dst.numel():
                raise ValueError(f"delta_apply_parts: run [{offset}, {offset + count}) "
                                 f"outside a destination of {s.dst.numel()}")
            idx_off, val_off = 0, pay
            pay = _align(pay + data.nbytes)
            pieces.append((val_off, data))
            flags, kind = esize << 8, RUN
            n_tiles = -(-(count * esize) // TILE_BYTES)
        rows.append([s.dst.data_ptr(), s.dst.numel(), count, offset, idx_off, val_off,
                     first_tile, kind | (flags << 32)])
        tiles.append(n_tiles)
        first_tile += n_tiles
    table = np.array(rows, dtype=np.int64).reshape(-1, SEGMENT_WORDS)
    tile_seg = np.repeat(np.arange(len(tiles), dtype=np.int32), tiles)
    map_off = _align(table.nbytes)
    payload_off = _align(map_off + tile_seg.nbytes)
    return StepPlan(payload_off + pay, int(tile_seg.size), map_off, payload_off, table,
                    tile_seg, pieces)


def write_step(plan: StepPlan, out: np.ndarray) -> None:
    """Pack ``plan`` into the uint8 buffer ``out`` (at least ``plan.nbytes``):
    one host copy of each payload array, straight from its wire bytes."""
    out[: plan.table.nbytes] = plan.table.reshape(-1).view(np.uint8)
    out[plan.map_off: plan.map_off + plan.tile_seg.nbytes] = plan.tile_seg.view(np.uint8)
    base = plan.payload_off
    for off, arr in plan.pieces:
        out[base + off: base + off + arr.nbytes] = arr.view(np.uint8)


class StepRing:
    """Pinned host slots (each with its device twin) for packed STAGE
    steps, used in turn.  A slot is reused only after the event recorded
    behind its last copy and launch has completed, so the host never
    rewrites pinned bytes a copy may still be reading.  A step larger than
    its slot grows that slot."""

    def __init__(self, device, slot_bytes: int, slots: int = 2):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"StepRing: pinned upload slots need a CUDA device, not "
                             f"{device}")
        self.device = torch.device("cuda", device.index if device.index is not None
                                   else torch.cuda.current_device())
        self._host: List[Optional[torch.Tensor]] = [None] * slots
        self._dev: List[Optional[torch.Tensor]] = [None] * slots
        self._done: List[Optional[torch.cuda.Event]] = [None] * slots
        self._turn = 0
        for k in range(slots):
            self._grow(k, slot_bytes)

    @property
    def pinned_bytes(self) -> int:
        return sum(h.numel() for h in self._host if h is not None)

    def _grow(self, k: int, nbytes: int) -> None:
        nbytes = max(ALIGN, -(-int(nbytes) // (1 << 20)) * (1 << 20))
        self._host[k] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self._dev[k] = torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def _slot(self, nbytes: int) -> int:
        """The next slot, once its last use is done, at least ``nbytes``."""
        k = self._turn % len(self._host)
        self._turn += 1
        if self._done[k] is not None:
            self._done[k].synchronize()
            self._done[k] = None
        if self._host[k] is None or self._host[k].numel() < nbytes:
            self._grow(k, nbytes)
        return k

    def apply(self, segments: Sequence[Segment]) -> StepPlan:
        """Pack, upload and apply one step: one pinned host-to-device copy
        and one launch on the current stream (none for an empty step)."""
        plan = plan_step(segments)
        if plan.n_tiles == 0:
            return plan
        from repro_torch.kernels.build import load_extension

        k = self._slot(plan.nbytes)
        host, dev = self._host[k], self._dev[k]
        write_step(plan, host.numpy())
        dev[: plan.nbytes].copy_(host[: plan.nbytes], non_blocking=True)
        load_extension().delta_apply_parts(dev, plan.map_off, plan.payload_off, plan.n_tiles)
        ops.count("delta_apply_inplace")
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._done[k] = done
        return plan

    def close(self) -> None:
        """Wait for the slots' last copies and let the memory go."""
        for ev in self._done:
            if ev is not None:
                ev.synchronize()
        self._host = [None] * len(self._host)
        self._dev = [None] * len(self._dev)
        self._done = [None] * len(self._done)


def delta_apply_parts(segments: Sequence[Segment], *,
                      ring: Optional[StepRing] = None) -> None:
    """Apply every segment of one step in place: one launch on the card.

    The segments write disjoint elements (the store's contract: one row
    per flat index, disjoint pages), so their order does not matter.  On
    the CPU the plain version applies them in order.  ``ring`` holds the
    pinned slots (a one-slot ring is made for the call when None)."""
    segments = list(segments)
    if not segments:
        return
    devices = {s.dst.device for s in segments}
    if len(devices) != 1:
        raise ValueError(f"delta_apply_parts: destinations on {sorted(map(str, devices))}, "
                         f"expected one device")
    (device,) = devices
    if device.type == "cpu":
        ref.delta_apply_parts(segments)
        return
    ops.require_cuda("delta_apply_parts", device, [("dst", s.dst) for s in segments])
    if ring is None:
        ring = StepRing(device, 0, slots=1)
    elif ring.device != device:
        raise ValueError(f"delta_apply_parts: ring on {ring.device}, destinations on {device}")
    ring.apply(segments)


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

    ext = load_extension()
    (ext.delta_apply_inplace if donate else ext.delta_apply)(out, indices, values)
    ops.count(name)
    return out
