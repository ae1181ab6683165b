"""Client/server update + licensing protocol (paper §3.1, Fig. 2).

Counterpart of ``repro.core.protocol``.  The paper's deployment plane is
Django + Hasura/GraphQL over Postgres; the same message flow is modelled
in-process, with bytes on the wire accounted exactly:

  1. the edge device sends (model, current_version, license);
  2. the server answers with an UpdatePacket of the weights created or
     updated since that version (skipping intermediate patches, §4.2),
     with the tier's license mask applied to the *shipped values*, so
     unlicensed weights never leave the server;
  3. the device applies the sparse delta to its tensors on the card
     (``core/delta.py``: the Hopper ``delta_apply`` scatter for rows,
     slice copies for chunk pages).

Chunk-granular fetch (staged weight sync): :meth:`LicenseServer.open_update`
answers the same query as ``handle_update`` but returns an
:class:`UpdateCursor`; the client then pulls bounded *parts*
(``fetch_update(cursor, max_bytes)``), masked one at a time, so an edge
pod can interleave transfer and apply with its serving loop.

The server side is numpy and sqlite only; bf16 layers travel as their
raw bits (see ``weightstore``), so packets and checksums are
byte-identical to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import delta as delta_lib
from repro_torch.core.compression import is_dynamics_param
from repro_torch.core.licensing import FULL_TIER, LicenseTier
from repro_torch.core.weightstore import (LayerDelta, UpdatePacket, WeightStore,
                                          as_float32)


@dataclass
class UpdateLog:
    model: str
    from_version: Optional[int]
    to_version: int
    tier: str
    bytes_sent: int
    entries: int


@dataclass
class UpdateCursor:
    """One incremental update session: the raw packet plus a read position.

    Produced by :meth:`LicenseServer.open_update`; consumed part by part
    through :meth:`LicenseServer.fetch_update`.  A *part* is a
    ``LayerDelta`` covering a slice of one layer's delta — a run of
    (index, value) rows or a run of whole chunk pages — so applying every
    fetched part in order reproduces ``handle_update``'s packet exactly.
    ``deltas`` are UNMASKED: masking runs per part at fetch time.
    """

    model: str
    from_version: Optional[int]
    to_version: int
    tier: str
    deltas: List[LayerDelta] = field(default_factory=list)
    tier_obj: Any = field(default=None, repr=False)
    _delta_i: int = 0            # next delta to slice from
    _entry_off: int = 0          # entries already taken from deltas[_delta_i]
    fetched_bytes: int = 0
    fetched_parts: int = 0
    _log: Any = field(default=None, repr=False)   # live UpdateLog entry

    @property
    def done(self) -> bool:
        return self._delta_i >= len(self.deltas)

    def tell(self) -> Tuple[int, int]:
        """The durable read position: (next delta index, entries already
        taken from it) — what a client resumes from after a lost response."""
        return (self._delta_i, self._entry_off)

    def seek(self, pos: Tuple[int, int]) -> None:
        """Reposition to a :meth:`tell` snapshot (the row-range resume)."""
        i, off = int(pos[0]), int(pos[1])
        if not 0 <= i <= len(self.deltas):
            raise ValueError(f"resume delta index {i} outside "
                             f"[0, {len(self.deltas)}]")
        if i == len(self.deltas):
            if off != 0:
                raise ValueError(f"resume offset {off} past the last delta")
        elif not 0 <= off < max(1, len(self.deltas[i].indices)):
            raise ValueError(f"resume offset {off} outside delta {i} "
                             f"({len(self.deltas[i].indices)} entries)")
        self._delta_i = i
        self._entry_off = off

    @property
    def total_bytes(self) -> int:
        """Pre-mask payload size."""
        return int(sum(d.nbytes for d in self.deltas))

    def _take(self, budget: int) -> LayerDelta:
        """Slice the next part off the cursor: at least one row/page, at
        most ``budget`` bytes (a single page may overshoot — the page is
        the smallest unit of transfer in chunk mode)."""
        d = self.deltas[self._delta_i]
        j = self._entry_off
        if d.chunks is not None:
            flags = d.chunk_flags()
            k, got = j, 0
            while k < len(d.chunks) and (k == j or
                                         got + len(d.chunks[k]) + 8 <= budget):
                got += len(d.chunks[k]) + 8
                k += 1
            part = LayerDelta(layer=d.layer, shape=d.shape, dtype=d.dtype,
                              indices=d.indices[j:k], chunks=d.chunks[j:k],
                              chunk_elems=d.chunk_elems,
                              chunk_compressed=flags[j:k])
        else:
            per = d.indices.itemsize + d.values.itemsize
            k = j + max(1, min(budget // per, len(d.indices) - j))
            part = LayerDelta(layer=d.layer, shape=d.shape, dtype=d.dtype,
                              indices=d.indices[j:k], values=d.values[j:k])
        self._entry_off = k
        if k >= len(d.indices):
            self._delta_i += 1
            self._entry_off = 0
        return part


class LicenseServer:
    """Cloud side: wraps the WeightStore + Accuracy-table tiers."""

    def __init__(self, store: WeightStore):
        self.store = store
        self.log: List[UpdateLog] = []

    # -- publishing -------------------------------------------------------
    def publish(self, model: str, params: Any, **commit_kw) -> int:
        return self.store.commit(model, params, **commit_kw)

    def publish_tier(self, model: str, tier: LicenseTier) -> None:
        version = self.store.production_version(model)
        self.store.register_tier(
            model, version, tier.name, tier.accuracy or 0.0, tier.as_json()
        )

    def tier(self, model: str, name: str) -> LicenseTier:
        if name == "full":
            return FULL_TIER
        acc, masks = self.store.get_tier(model, name)
        return LicenseTier.from_json(name, masks, acc)

    def has_tier(self, model: str, name: str) -> bool:
        """Convenience predicate over :meth:`tier` (which raises KeyError)."""
        try:
            self.tier(model, name)
            return True
        except KeyError:
            return False

    # -- update requests ---------------------------------------------------
    def handle_update(
        self, model: str, client_version: Optional[int], license_name: str = "full"
    ) -> UpdatePacket:
        """§3.1.2: respond with only created/updated weights since the
        client's version, masked per the client's license tier."""
        tier = self.tier(model, license_name)
        packet = self.store.delta_since(model, client_version)
        packet = _mask_packet(packet, tier)
        self.log.append(UpdateLog(
            model=model, from_version=client_version, to_version=packet.to_version,
            tier=license_name, bytes_sent=packet.nbytes, entries=packet.num_entries,
        ))
        return packet

    def production_version(self, model: str) -> Optional[int]:
        """Cheap poll: the current production version id (None if unset)."""
        return self.store.production_version(model, missing_ok=True)

    def open_update(
        self, model: str, client_version: Optional[int],
        license_name: str = "full",
        resume: Optional[Tuple[int, int]] = None,
    ) -> UpdateCursor:
        """Chunk-granular variant of :meth:`handle_update`: same query,
        same masking (per part, in :meth:`fetch_update`).  The session is
        logged at once, so an abandoned sync stays in the audit trail.
        ``resume`` is a :meth:`UpdateCursor.tell` snapshot of an earlier
        session against the same ``(model, client_version)``; the query
        is deterministic, so the resumed row ranges line up."""
        tier = self.tier(model, license_name)
        packet = self.store.delta_since(model, client_version)
        entry = UpdateLog(model=model, from_version=client_version,
                          to_version=packet.to_version, tier=license_name,
                          bytes_sent=0, entries=0)
        self.log.append(entry)
        cursor = UpdateCursor(model=model, from_version=client_version,
                              to_version=packet.to_version, tier=license_name,
                              deltas=packet.deltas, tier_obj=tier, _log=entry)
        if resume is not None:
            cursor.seek(resume)
        return cursor

    def fetch_update(self, cursor: UpdateCursor,
                     max_bytes: int = 1 << 20) -> List[LayerDelta]:
        """Pull the next parts off an open cursor: at least one part, at
        most ~``max_bytes`` on the wire (one chunk page may overshoot),
        masked per the session's tier as they are sliced.  Returns ``[]``
        once the cursor is drained."""
        parts: List[LayerDelta] = []
        got = 0
        while not cursor.done and (not parts or got < max_bytes):
            raw = cursor._take(max_bytes - got)
            part = _mask_packet(
                UpdatePacket(model=cursor.model,
                             from_version=cursor.from_version,
                             to_version=cursor.to_version, deltas=[raw]),
                cursor.tier_obj).deltas[0]
            parts.append(part)
            got += part.nbytes
            cursor._log.entries += len(part.indices)
        cursor.fetched_bytes += got
        cursor.fetched_parts += len(parts)
        cursor._log.bytes_sent = cursor.fetched_bytes
        return parts


def _mask_page(page: np.ndarray, ivs: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Interval-mask one decoded page (or rows-value array) in its own
    dtype: |w| is taken in float32 (from the bits for bf16), kept entries
    pass through bit-identically and zeroed entries become +0 (``0x0000``
    for bf16)."""
    mag = np.abs(as_float32(page))
    dead = np.zeros(page.shape, bool)
    for lo, hi in ivs:
        dead |= (mag >= lo) & (mag < hi)
    return np.where(dead, np.zeros((), page.dtype), page)


def _mask_packet(packet: UpdatePacket, tier: LicenseTier) -> UpdatePacket:
    """Apply license masks to the values being shipped (server-side access
    control: free-tier clients never receive masked weights).  Dynamics
    parameters and 1-D layers are never masked; chunk pages are decoded
    under their explicit compression flags, masked, and re-encoded."""
    if not tier.masks:
        return packet
    import zlib

    out = UpdatePacket(model=packet.model, from_version=packet.from_version,
                       to_version=packet.to_version)
    for d in packet.deltas:
        ivs = tier.intervals_for(d.layer)
        if not ivs or is_dynamics_param(d.layer) or len(d.shape) < 2:
            out.deltas.append(d)
        elif d.chunks is not None:
            masked_chunks = []
            flags = d.chunk_flags()
            for (_, page), compressed in zip(d.iter_pages(), flags):
                blob = _mask_page(page, ivs).tobytes()
                masked_chunks.append(zlib.compress(blob, 1) if compressed else blob)
            out.deltas.append(LayerDelta(layer=d.layer, shape=d.shape, dtype=d.dtype,
                                         indices=d.indices, chunks=masked_chunks,
                                         chunk_elems=d.chunk_elems,
                                         chunk_compressed=flags))
        else:
            out.deltas.append(LayerDelta(layer=d.layer, shape=d.shape, dtype=d.dtype,
                                         indices=d.indices,
                                         values=_mask_page(np.asarray(d.values), ivs)))
    return out


class EdgeClient:
    """Edge-device side: holds local params (tensors on their device) and
    their version, and pulls delta updates."""

    def __init__(self, model: str, params_template: Any, license_name: str = "full"):
        self.model = model
        self.params = params_template
        self.version: Optional[int] = None
        self.license_name = license_name
        self.bytes_downloaded = 0
        self.updates = 0

    def request_update(self, server, retry=None) -> UpdatePacket:
        """Pull one whole-packet update.  ``server`` may be a raw
        :class:`LicenseServer` or any ``core.transport.Transport`` over
        one; with ``retry`` (a ``RetryPolicy``), a timed-out or corrupted
        delivery is re-requested (the query is a pure read)."""
        from repro_torch.core.transport import as_transport

        transport = as_transport(server)

        def _pull() -> UpdatePacket:
            return transport.handle_update(self.model, self.version,
                                           self.license_name)

        packet = _pull() if retry is None else retry.run(_pull)
        if packet.to_version != self.version:
            self.params = delta_lib.apply_packet(self.params, packet)
            self.version = packet.to_version
            self.bytes_downloaded += packet.nbytes
            self.updates += 1
        return packet
