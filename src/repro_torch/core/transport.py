"""Fault-tolerant wire seam between edge serving and the LicenseServer.

Counterpart of ``repro.core.transport``, pure Python: the same errors,
retry policy, transports and fault schedule, and checksums equal to the
JAX package's for the same packet.  Edge deployments live with the
intermittent connectivity the paper's setting implies, so every wire
call of ``EdgeClient``, ``UpdateStager`` and the gateway goes through a
:class:`Transport`:

* :class:`DirectTransport` — today's behavior: an in-process method
  call that never faults.  Server methods are looked up per call, so
  tests that monkeypatch e.g. ``server.fetch_update`` keep working.
* :class:`ChaosTransport` — deterministic, seed-scheduled fault
  injection: timeouts, mid-stream disconnects, latency spikes,
  duplicate deliveries, and payload corruption.  Only the *wire* is
  perturbed — server state is never damaged, and a corrupted payload
  never survives past the checksum check — so a fault schedule can
  change timing, retry counters, and lease state, never tokens.

Payload integrity rides the same seam: :func:`part_checksum` digests
one ``LayerDelta`` part's wire payload, the transport computes digests
at *send* and :func:`verify_parts` re-digests on *receipt*, so a
corrupted page raises :class:`PayloadCorruption` instead of being
applied.  :class:`RetryPolicy` (exponential backoff + deterministic
jitter + deadline, injectable clock/sleep) is the one retry loop every
wire caller shares.
"""
from __future__ import annotations

import copy
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "TransportError", "TransportTimeout", "TransportDisconnect",
    "PayloadCorruption", "part_checksum", "packet_checksum", "verify_parts",
    "RetryPolicy", "Transport", "DirectTransport", "ChaosTransport",
    "as_transport",
]


# ------------------------------------------------------------------ failures
class TransportError(RuntimeError):
    """Base class for transient wire failures — every subclass is safe
    to retry: either the request never reached the server (timeout) or
    re-issuing it is idempotent at the protocol level (the update query
    is a pure read; delta application is idempotent per entry)."""


class TransportTimeout(TransportError):
    """The request was lost *before* the server processed it: no
    server-side state advanced, the caller simply never got an answer."""


class TransportDisconnect(TransportError):
    """The connection died mid-stream: the server *did* process the call
    (an open cursor advanced past the lost parts) but the response never
    arrived.  The caller must resume from its last durable position, not
    merely re-issue the same fetch."""


class PayloadCorruption(TransportError):
    """A delivered payload failed its checksum — the bytes on the wire
    do not match what the server sent.  The payload must be discarded
    and re-fetched, never applied."""


# ----------------------------------------------------------------- checksums
def part_checksum(part: Any) -> int:
    """CRC32 of one ``LayerDelta`` part's wire payload (layer name,
    indices, and values/pages).  Computed at send and re-computed at
    receipt; a mismatch means the wire flipped bits.  The arrays are
    digested through their buffers, with no byte copy (a full pull of the
    3B model carries ~27 GB of indices)."""
    crc = zlib.crc32(part.layer.encode())
    crc = zlib.crc32(np.ascontiguousarray(part.indices), crc)
    if part.chunks is not None:
        for blob in part.chunks:
            crc = zlib.crc32(blob, crc)
    else:
        crc = zlib.crc32(np.ascontiguousarray(part.values), crc)
    return crc & 0xFFFFFFFF


def packet_checksum(packet: Any) -> int:
    """Whole-``UpdatePacket`` digest: the per-part digests chained in
    order (order matters — parts apply sequentially)."""
    crc = 0
    for d in packet.deltas:
        crc = zlib.crc32(part_checksum(d).to_bytes(4, "little"), crc)
    return crc & 0xFFFFFFFF


def verify_parts(parts: Iterable[Any], digests: Iterable[int]) -> None:
    """Receive-side integrity check: re-digest each delivered part
    against the digest computed at send."""
    for i, (part, digest) in enumerate(zip(parts, digests)):
        got = part_checksum(part)
        if got != digest:
            raise PayloadCorruption(
                f"part {i} ({part.layer!r}): checksum {got:#010x} != "
                f"sent {digest:#010x}")


# --------------------------------------------------------------------- retry
@dataclass
class RetryPolicy:
    """Exponential backoff with deterministic jitter and a deadline.

    One policy instance wraps every wire call of a caller (stager,
    client, gateway): ``run(fn)`` re-invokes ``fn`` on
    :class:`TransportError` until it succeeds, ``max_attempts`` are
    spent, or the next backoff would cross ``deadline_s``.  ``clock``
    and ``sleep`` are injectable so tests and benchmarks run the policy
    without real waiting; jitter derives from ``(seed, attempt)``, never
    from a global RNG, so a retry schedule is reproducible.
    """

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1          # +/- fraction of the backoff
    deadline_s: Optional[float] = None
    seed: int = 0
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered
        deterministically into ``[d*(1-jitter), d*(1+jitter)]``."""
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter:
            u = zlib.crc32(f"{self.seed}:{attempt}".encode()) / 0xFFFFFFFF
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)

    def run(self, fn: Callable[[], Any], *,
            retryable: Tuple[type, ...] = (TransportError,),
            on_retry: Optional[Callable[[int, BaseException, float],
                                        None]] = None) -> Any:
        """Call ``fn`` until success or the budget is spent; the final
        failure re-raises.  ``on_retry(attempt, exc, delay)`` fires
        before each backoff — the hook where callers count retries and
        emit ``sync_retry`` audit events."""
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn()
            except retryable as exc:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                delay = self.delay(attempt)
                if (self.deadline_s is not None
                        and self.clock() - start + delay > self.deadline_s):
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                if delay > 0.0:
                    self.sleep(delay)


# ----------------------------------------------------------------- transports
class Transport:
    """The wire seam: one instance fronts one ``LicenseServer``.

    Methods mirror the server's wire surface (``production_version``,
    ``open_update``, ``fetch_update``, ``handle_update``, ``tier``);
    subclasses perturb delivery by overriding :meth:`_call`.  Payload
    digests are computed at send inside the thunk and verified on
    receipt here, so every fetched part / pulled packet passes an
    integrity check regardless of transport."""

    def __init__(self, server: Any):
        self.server = server
        self.stats: Dict[str, int] = {
            "calls": 0, "faults": 0, "timeouts": 0, "disconnects": 0,
            "corruptions": 0, "duplicates": 0, "latency_spikes": 0,
        }

    # subclass seam: deliver one call (may fault, delay, or duplicate)
    def _call(self, op: str, thunk: Callable[[], Any]) -> Any:
        self.stats["calls"] += 1
        return thunk()

    # ---------------------------------------------------------- wire surface
    def production_version(self, model: str) -> Optional[int]:
        return self._call("production_version",
                          lambda: self.server.production_version(model))

    def open_update(self, model: str, client_version: Optional[int],
                    license_name: str = "full",
                    resume: Optional[Tuple[int, int]] = None) -> Any:
        if resume is None:      # plain call: monkeypatched servers keep working
            return self._call("open_update", lambda: self.server.open_update(
                model, client_version, license_name))
        return self._call("open_update", lambda: self.server.open_update(
            model, client_version, license_name, resume=resume))

    def fetch_update(self, cursor: Any, max_bytes: int = 1 << 20) -> List[Any]:
        def thunk():
            parts = self.server.fetch_update(cursor, max_bytes)
            return parts, [part_checksum(p) for p in parts]

        parts, digests = self._call("fetch_update", thunk)
        verify_parts(parts, digests)
        return parts

    def handle_update(self, model: str, client_version: Optional[int],
                      license_name: str = "full") -> Any:
        def thunk():
            packet = self.server.handle_update(model, client_version,
                                               license_name)
            return packet, packet_checksum(packet)

        packet, digest = self._call("handle_update", thunk)
        if packet_checksum(packet) != digest:
            raise PayloadCorruption(
                f"update packet {model}@{packet.to_version}: checksum "
                f"mismatch")
        return packet

    def tier(self, model: str, name: str) -> Any:
        return self._call("tier", lambda: self.server.tier(model, name))


class DirectTransport(Transport):
    """In-process delivery, never faults — the pre-transport behavior."""


def as_transport(server_or_transport: Any) -> Transport:
    """Accept either a raw ``LicenseServer`` or an already-built
    transport, so every wire API keeps taking plain servers."""
    if isinstance(server_or_transport, Transport):
        return server_or_transport
    return DirectTransport(server_or_transport)


def _corrupt_part(part: Any) -> Any:
    """A copy of ``part`` with one payload byte flipped (the wire's
    damage) — the original, and server state behind it, are untouched."""
    from repro_torch.core.weightstore import LayerDelta

    if part.chunks is not None and part.chunks:
        chunks = list(part.chunks)
        blob = bytearray(chunks[0])
        if blob:
            blob[len(blob) // 2] ^= 0xFF
        chunks[0] = bytes(blob)
        return LayerDelta(layer=part.layer, shape=part.shape,
                          dtype=part.dtype, indices=part.indices,
                          chunks=chunks, chunk_elems=part.chunk_elems,
                          chunk_compressed=part.chunk_flags())
    vals = np.ascontiguousarray(np.asarray(part.values)).copy()
    raw = vals.view(np.uint8).reshape(-1)
    if raw.size:
        raw[raw.size // 2] ^= 0xFF
    return LayerDelta(layer=part.layer, shape=part.shape, dtype=part.dtype,
                      indices=part.indices, values=vals)


class ChaosTransport(Transport):
    """Deterministic, seed-scheduled fault injection at the wire seam.

    Every delivery decision is drawn from ``random.Random(f"{seed}:{op}:{n}")``
    where ``n`` is that op's call index — the schedule depends only on
    the seed and each op's own call sequence, never on thread
    interleaving or wall time, so a chaos run is reproducible (the
    background-fetch worker and the serving thread can share one
    instance).

    Per call, in order: a latency spike (``spike_rate`` /
    ``latency_spike_s``, via the injectable ``sleep``), then one of the
    weighted faults at ``fault_rate``:

    * ``timeout``    — request lost before the server sees it (no
      server-side effect) → :class:`TransportTimeout`;
    * ``disconnect`` — the server processes the call (a cursor
      advances!) but the response is lost → :class:`TransportDisconnect`;
    * ``corrupt``    — the payload arrives with a flipped byte; the
      send-side digest catches it → :class:`PayloadCorruption`
      (fetch/handle ops only — versionless ops degrade to timeout).

    Independently, ``dup_rate`` re-delivers the previous successful
    fetch batch verbatim (network duplicate): the cursor does not
    advance and the client re-applies an already-applied batch — which
    must be (and is) idempotent.
    """

    _PAYLOAD_OPS = ("fetch_update", "handle_update")

    def __init__(self, server: Any, *, seed: int = 0, fault_rate: float = 0.2,
                 timeout_weight: float = 1.0, disconnect_weight: float = 1.0,
                 corrupt_weight: float = 1.0, dup_rate: float = 0.0,
                 spike_rate: float = 0.0, latency_spike_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_ops: Optional[Iterable[str]] = None):
        super().__init__(server)
        self.seed = int(seed)
        self.fault_rate = float(fault_rate)
        self.weights = {"timeout": float(timeout_weight),
                        "disconnect": float(disconnect_weight),
                        "corrupt": float(corrupt_weight)}
        self.dup_rate = float(dup_rate)
        self.spike_rate = float(spike_rate)
        self.latency_spike_s = float(latency_spike_s)
        self.sleep = sleep
        self.fault_ops = None if fault_ops is None else frozenset(fault_ops)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}                   # guarded-by: _lock
        self._last_fetch: Optional[Tuple[List[Any], List[int]]] = None  # guarded-by: _lock

    def _decide(self, op: str):
        with self._lock:
            n = self._counts.get(op, 0)
            self._counts[op] = n + 1
        rng = random.Random(f"{self.seed}:{op}:{n}")
        spike = rng.random() < self.spike_rate
        dup = op == "fetch_update" and rng.random() < self.dup_rate
        fault = None
        if rng.random() < self.fault_rate:
            weights = dict(self.weights)
            if op not in self._PAYLOAD_OPS:
                # nothing to corrupt on a versionless/tier call
                weights["timeout"] += weights.pop("corrupt")
            kinds = [k for k, w in weights.items() if w > 0]
            fault = rng.choices(kinds, [weights[k] for k in kinds])[0]
        return rng, spike, dup, fault

    def _call(self, op: str, thunk: Callable[[], Any]) -> Any:
        self.stats["calls"] += 1
        if self.fault_ops is not None and op not in self.fault_ops:
            return thunk()
        rng, spike, dup, fault = self._decide(op)
        if spike and self.latency_spike_s > 0.0:
            self.stats["latency_spikes"] += 1
            self.sleep(self.latency_spike_s)
        if fault == "timeout":
            self.stats["faults"] += 1
            self.stats["timeouts"] += 1
            raise TransportTimeout(f"{op}: request timed out")
        if dup:
            with self._lock:
                last = copy.deepcopy(self._last_fetch)
            if last is not None:
                # duplicate delivery: the previous batch arrives again;
                # the server (and its cursor) never sees this call
                self.stats["duplicates"] += 1
                return last
        result = thunk()
        if fault == "disconnect":
            self.stats["faults"] += 1
            self.stats["disconnects"] += 1
            raise TransportDisconnect(f"{op}: connection lost mid-stream")
        if fault == "corrupt":
            # digests were computed from the pristine payload inside the
            # thunk; flip a byte in a COPY on the way out — the caller's
            # verify_parts/packet check turns this into PayloadCorruption
            if op == "fetch_update":
                parts, digests = result
                hot = [i for i, p in enumerate(parts) if p.nbytes > 0]
                if hot:
                    self.stats["faults"] += 1
                    self.stats["corruptions"] += 1
                    delivered = list(parts)
                    k = hot[rng.randrange(len(hot))]
                    delivered[k] = _corrupt_part(delivered[k])
                    result = (delivered, digests)
            elif op == "handle_update":
                packet, digest = result
                if packet.deltas:
                    self.stats["faults"] += 1
                    self.stats["corruptions"] += 1
                    deltas = list(packet.deltas)
                    k = rng.randrange(len(deltas))
                    deltas[k] = _corrupt_part(deltas[k])
                    from repro_torch.core.weightstore import UpdatePacket

                    result = (UpdatePacket(model=packet.model,
                                           from_version=packet.from_version,
                                           to_version=packet.to_version,
                                           deltas=deltas), digest)
        if op == "fetch_update" and isinstance(result, tuple):
            snap = copy.deepcopy(result)
            with self._lock:
                self._last_fetch = snap
        return result
