"""Staged weight sync: version bumps that never stall a decode step.

Counterpart of ``repro/serving/updates.py``.  :class:`UpdateStager`
splits a version bump into small, *bounded* steps the gateway interleaves
with its scheduler iterations:

```
poll ──▶ STAGE ──▶ REQUANT ──▶ PREWARM ──▶ FLIP
         (fetch one ≤max_step_bytes part      (int8 path: re-quantize
          from the server's UpdateCursor       ≤requant_layers_per_step
          and apply it to the staging copy     TOUCHED layers per step,
          of its layer on the card)            reusing every untouched
                                               leaf of the live store)
                               (materialize the TierViewCache entry of
                                one currently-hot tier per step at the
                                NEW version, before anything serves it)
                                              (one atomic step: bump the
                                               gateway/client version AND
                                               apply tier redefinitions
                                               published alongside it)
```

Invariants the stager preserves:

* **Serving state is untouched until the flip.**  A touched layer's
  staging copy is a ``clone()`` of the serving tensor, made on the card
  when the layer's first part arrives; every later part of it is applied
  in place (rows through the ``delta_apply_inplace`` kernel, chunk pages
  as slice copies).  It stays on the card and is never downloaded.
  In-flight requests stay pinned to their admitted version and produce
  the tokens of an update-free run.
* **Bounded work per step.**  A STAGE step transfers and applies at most
  ``max_step_bytes`` of delta (one indivisible chunk page may
  overshoot) plus, at a layer's first part, one device-side copy of that
  layer; a REQUANT step re-quantizes at most ``requant_layers_per_step``
  layers; a PREWARM step builds one tier view.
* **Atomic flip.**  Tier redefinitions published with the version bump
  go live in the same step that installs the new weights.  A redefined
  tier still serving in-flight requests at the flip defers, and refuses
  new admissions until it drains.

The wire transfer may run on a background worker thread (bounded queue,
``fetch_depth`` batches ahead); the apply, the reopen of a dead cursor
(sqlite is bound to the serving thread) and the flip stay on the serving
thread.  Wire faults retry under the gateway's ``RetryPolicy`` and
resume from the last applied cursor position.  The worker/serving
protocol carries the JAX package's lockstep hooks
(``analysis/lockstep.py``): checkpoints where cursor state is touched,
and ownership handoffs at the worker's start and join.

With telemetry on, every step is a ``stager:<phase>`` complete event on
the trace's stager track and one observation of ``h_stager``, and the
audit records ``sync_begin`` and ``sync_abort`` (the slot records
``sync_retry``/``sync_quarantine``, the gateway ``version_flip``).  The
step's window is host clock: a stage step's device work (the layer
clone, the in-place scatter, a requant) is only launched inside it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.analysis import lockstep
from repro_torch.core.delta import apply_delta
from repro_torch.core.pytree_io import flatten_params, unflatten_like
from repro_torch.core.transport import (PayloadCorruption, RetryPolicy, Transport,
                                        TransportError, TransportTimeout,
                                        as_transport)
from repro_torch.serving.tracing import STAGER_TID

# the cursor-protocol fields whose ownership moves with the fetch
# worker (see the guarded-by annotations in __init__ and
# repro_torch.analysis.lockstep for the dynamic check)
_WORKER_FIELDS = ("_cursor", "_pos", "_cursor_dead")


class _ReopenRequired(Exception):
    """Internal worker→serving-thread signal: the cursor is dead (a
    disconnect or corrupted delivery) and reopening it needs the §4.2
    delta query — sqlite, which is bound to the serving thread.  Never
    escapes the stager."""


class UpdateStager:
    """Incremental ``sync()``: fetch → stage → requantize → prewarm → flip.

    One stager serves one update session; the gateway constructs it in
    :meth:`LicensedGateway.begin_sync` and advances it one :meth:`step`
    per scheduler iteration (or in a tight loop for the blocking
    ``sync()``).  ``stats()`` exports the per-step accounting.
    """

    def __init__(self, gateway: Any, server: Any, *,
                 max_step_bytes: int = 256 << 10,
                 requant_layers_per_step: int = 2,
                 background_fetch: bool = True,
                 fetch_depth: int = 2,
                 transport: Optional[Transport] = None,
                 retry: Optional[RetryPolicy] = None,
                 join_timeout_s: float = 5.0):
        self.gw = gateway
        # every wire call goes through a Transport; when the gateway was
        # booted against the same server, its transport is reused so one
        # seam governs the sync
        if transport is not None:
            self.transport = transport
        elif isinstance(server, Transport):
            self.transport = server
        else:
            gwt = getattr(gateway, "_transport", None)
            self.transport = (gwt if gwt is not None and gwt.server is server
                              else as_transport(server))
        self.server = self.transport.server
        self.retry = (retry if retry is not None
                      else getattr(gateway, "retry_policy", None)
                      or RetryPolicy())
        self.join_timeout_s = float(join_timeout_s)
        self.max_step_bytes = int(max_step_bytes)
        self.requant_layers_per_step = int(requant_layers_per_step)
        self.background_fetch = bool(background_fetch)
        self.fetch_depth = max(1, int(fetch_depth))
        self._fetch_thread = None
        self._fetch_queue = None
        self._fetch_stop = None
        self.phase = "idle"
        self.to_version: Optional[int] = None
        self._cursor = None  # guarded-by: owner(__init__, begin, _reopen, abort, _flip)
        self._staged: Any = None          # staged float params (assembled at drain)
        self._staged_q: Any = None        # staging int8 store (quantized path)
        self._touched: Set[str] = set()   # layer names the delta touched
        self._requant_queue: List[str] = []
        self._prewarm_queue: List[str] = []
        # fault-tolerance state: the last durably-applied cursor position
        # (the resume token), wire bytes accumulated across reopened
        # sessions, and whether the current cursor may have advanced past
        # parts the client never received
        self._pos: Tuple[int, int] = (0, 0)  # guarded-by: owner(__init__, begin, _fetch_parts)
        self._wire_bytes = 0  # guarded-by: owner(__init__, begin, _reopen)
        self._cursor_dead = False  # guarded-by: owner(__init__, begin, _reconnect, _fetch_parts)
        self.stats_: Dict[str, Any] = {
            "steps": 0, "parts_applied": 0, "bytes_applied": 0,
            "max_step_bytes_applied": 0, "layers_requantized": 0,
            "views_prewarmed": 0, "flips": 0,
            "retries": 0, "resumes": 0, "corrupt_parts": 0,
            "fetch_workers_leaked": 0,
        }

    # ------------------------------------------------------------------ state
    @property
    def active(self) -> bool:
        return self.phase not in ("idle", "done", "failed")

    def stats(self) -> Dict[str, Any]:
        out = dict(self.stats_)
        out["phase"] = self.phase
        out["to_version"] = self.to_version
        out["layers_touched"] = len(self._touched)
        out["max_step_bytes_bound"] = self.max_step_bytes
        out["background_fetch"] = self.background_fetch
        out["wire"] = dict(self.transport.stats)
        return out

    # ------------------------------------------------------------------ begin
    def begin(self) -> bool:
        """Poll the server.  True when a staged session started (a newer
        production version exists); False when the client is current
        (tier-only redefinitions then apply at once) or the newer version
        is quarantined.  Wire faults retry under the policy; exhaustion
        raises ``TransportError``."""
        gw, client = self.gw, self.gw._client
        # cheap poll first: a no-op sync must not pay the §4.2 delta
        # query or leave an empty session in the server's audit log
        prod = self._wire(lambda: self.transport.production_version(gw.model))
        if prod == client.version:
            gw._refresh_server_tiers()
            self.phase = "done"
            return False
        if prod in gw.quarantined_versions:
            self.phase = "done"
            return False
        cursor = self._wire(lambda: self.transport.open_update(
            gw.model, client.version, client.license_name))
        if cursor.to_version == client.version:   # raced: moved back to us
            gw._refresh_server_tiers()
            self.phase = "done"
            return False
        if cursor.to_version in gw.quarantined_versions:
            self.phase = "done"
            return False
        if cursor.to_version < gw.version:
            raise ValueError(
                f"server production version {cursor.to_version} is older "
                f"than the gateway's current version {gw.version}")
        self._cursor = cursor
        self.to_version = cursor.to_version
        self._pos = cursor.tell()
        self._wire_bytes = 0
        self._cursor_dead = False
        # flat staging view: untouched layers stay the client's tensors by
        # reference; a touched layer is cloned on the card at its first
        # part and patched in place from then on
        self._flat = dict(flatten_params(client.params))
        self._pending_layer: Optional[str] = None
        self._staged = None
        self._touched = set()
        # incremental requant reuses the live int8 store's untouched
        # leaves; that store must correspond to the client's version
        # (always true through the sync API — otherwise one full
        # requantize step is the fallback)
        self._requant_base = (gw._weights.get(gw.version)
                              if gw.quantized and gw.version == client.version
                              else None)
        self.phase = "stage"
        if gw.obs:
            gw.audit.record("sync_begin", model=gw.model,
                            from_version=client.version,
                            to_version=cursor.to_version)
        if self.background_fetch:
            self._start_fetch_worker()
        return True

    # ------------------------------------------------------------ wire faults
    def _note_retry(self, attempt: int, exc: BaseException,
                    delay: float) -> None:
        """Per-retry accounting hook (runs on whichever thread made the
        wire call): stager counters and slot counters."""
        self.stats_["retries"] += 1
        if isinstance(exc, PayloadCorruption):
            self.stats_["corrupt_parts"] += 1
        self.gw._count_wire_retry(attempt, exc, delay,
                                  to_version=self.to_version)

    def _wire(self, fn):
        """One wire call under the retry policy; success renews the
        license lease timestamp."""
        result = self.retry.run(fn, on_retry=self._note_retry)
        self.gw._lease_renew()
        return result

    def _reopen(self) -> None:
        """Reconnect after a lost or corrupted delivery: the dead cursor
        is abandoned (its session log entry stays) and a fresh session is
        opened, seeked to the last durably-applied position."""
        gw, client = self.gw, self.gw._client
        lockstep.checkpoint("stager.reopen",
                            touches=("_cursor", "_wire_bytes"))
        old, self._cursor = self._cursor, None
        if old is not None:
            self._wire_bytes += old.fetched_bytes
        cursor = self.transport.open_update(gw.model, client.version,
                                            client.license_name,
                                            resume=self._pos)
        if cursor.to_version != self.to_version:
            # the server moved on mid-sync: resuming would splice two
            # different deltas — not transient, abort the session
            raise RuntimeError(
                f"server production version moved {self.to_version} -> "
                f"{cursor.to_version} mid-sync; aborting this session")
        self._cursor = cursor
        self.stats_["resumes"] += 1

    def _reconnect(self) -> None:
        """Serving-thread reopen: clears the dead-cursor flag once the
        fresh session is seeked into place."""
        self._reopen()
        self._cursor_dead = False

    def _fetch_parts(self, allow_reopen: bool = True,
                     ) -> Tuple[List[Any], bool]:
        """One bounded parts batch off the wire, surviving faults; returns
        ``(parts, done)``.  Runs on the fetch worker when background fetch
        is on, on the serving thread otherwise — the only mutator of
        cursor/position state while fetching.  ``allow_reopen=False`` (the
        worker): a dead cursor raises :class:`_ReopenRequired` instead of
        reopening, since the reopen runs the sqlite-backed delta query."""

        lockstep.checkpoint("stager.fetch_parts", touches=_WORKER_FIELDS)

        def attempt():
            if self._cursor_dead:
                if not allow_reopen:
                    raise _ReopenRequired()
                self._reconnect()
            try:
                return self.transport.fetch_update(self._cursor,
                                                   self.max_step_bytes)
            except TransportTimeout:
                # the request never reached the server: the cursor is
                # intact, a plain retry re-issues the same fetch
                raise
            except TransportError:
                # a disconnect may have advanced the cursor past lost
                # parts; a corrupt delivery did — both resume via a
                # reopen seeked to _pos
                self._cursor_dead = True
                raise

        parts = self.retry.run(attempt, on_retry=self._note_retry)
        # durable position: everything up to here is about to be applied
        lockstep.checkpoint("stager.advance_pos", touches=("_pos",))
        self._pos = self._cursor.tell()
        self.gw._lease_renew()
        return parts, self._cursor.done

    # ------------------------------------------------------- background fetch
    def _start_fetch_worker(self) -> None:
        """Spawn the wire-transfer worker: it loops ``fetch_update``
        against the (private, in-memory) cursor and hands each bounded
        parts batch through a depth-limited queue.  Only the transfer is
        off-thread; the apply consumes the queue on the serving thread."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.fetch_depth)
        stop = threading.Event()

        def _loop() -> None:
            try:
                while not stop.is_set():
                    try:
                        parts, done = self._fetch_parts(allow_reopen=False)
                    except _ReopenRequired:
                        while not stop.is_set():
                            try:
                                q.put(("reconnect", None, False),
                                      timeout=0.05)
                                return
                            except queue.Full:
                                continue
                        return
                    while not stop.is_set():
                        try:
                            q.put(("parts", parts, done), timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if done:
                        return
            except BaseException as exc:  # noqa: BLE001 — relayed to step()
                # surface the failure on the serving thread: _step_stage
                # re-raises it and step() aborts the session
                while not stop.is_set():
                    try:
                        q.put(("error", exc, True), timeout=0.05)
                        return
                    except queue.Full:
                        continue

        self._fetch_queue = q
        self._fetch_stop = stop
        self._fetch_thread = threading.Thread(
            target=_loop, name="update-stager-fetch", daemon=True)
        # the handoff point: from here until the join in
        # _stop_fetch_worker, cursor state belongs to the worker
        lockstep.transfer_ownership(_WORKER_FIELDS, "worker")
        self._fetch_thread.start()

    def _stop_fetch_worker(self) -> bool:
        """Tear the worker down (idempotent): signal stop, unblock any
        pending put by draining, join.  Returns False — and records the
        leak in ``stats()`` — when the worker is still alive after
        ``join_timeout_s``: callers on the flip path then fail the sync
        rather than flip with a live worker."""
        if self._fetch_thread is None:
            return True
        import queue

        self._fetch_stop.set()
        try:
            while True:
                self._fetch_queue.get_nowait()
        except queue.Empty:
            pass
        self._fetch_thread.join(timeout=self.join_timeout_s)
        leaked = self._fetch_thread.is_alive()
        if leaked:
            self.stats_["fetch_workers_leaked"] += 1
        else:
            # join is the visibility barrier: cursor state is the serving
            # thread's again (a leaked worker keeps ownership)
            lockstep.transfer_ownership(_WORKER_FIELDS, "serve")
        self._fetch_thread = None
        self._fetch_queue = None
        self._fetch_stop = None
        return not leaked

    # ------------------------------------------------------------------- step
    def step(self) -> Optional[str]:
        """Run ONE bounded unit of staging work; returns the phase that
        executed (None when the stager is idle/done).

        A step that raises ABORTS the session first (staging state torn
        down, the pre-registered version and any prewarmed views dropped)
        and then re-raises: the gateway keeps serving on its current
        version and a later ``begin_sync`` starts from scratch."""
        if not self.active:
            return None
        phase = self.phase
        self.stats_["steps"] += 1
        gw = self.gw
        t0 = gw.clock() if gw.obs else 0.0
        try:
            if phase == "stage":
                self._step_stage()
            elif phase == "requant":
                self._step_requant()
            elif phase == "prewarm":
                self._step_prewarm()
            elif phase == "flip":
                self._flip()
        except BaseException:
            self.abort()
            raise
        if gw.obs:
            t1 = gw.clock()
            gw.h_stager.observe(t1 - t0)
            gw.tracer.complete("stager:" + phase, t0, t1, tid=STAGER_TID,
                               attrs={"to_version": self.to_version})
        return phase

    def abort(self) -> None:
        """Tear down an in-progress session (no-op once done/failed).
        Everything staged is private until the flip, so aborting drops it,
        plus the pre-registered version if prewarm had begun."""
        if not self.active:
            return
        self._stop_fetch_worker()
        gw = self.gw
        if self.to_version is not None \
                and gw._staging_version == self.to_version:
            gw._weights.pop(self.to_version, None)
            gw.views.invalidate(version=self.to_version)
            if gw.prefix is not None:
                gw.prefix.drop_scope(version=self.to_version)
            gw._staging_version = None
        self._cursor = None
        self._staged = self._staged_q = None
        self._pending_layer = None
        if gw.obs:
            gw.audit.record("sync_abort", model=gw.model,
                            phase=self.phase, to_version=self.to_version)
        if self.to_version is not None:
            gw._note_sync_failure(self.to_version)
        self.phase = "failed"

    def _apply_part(self, part) -> None:
        """Apply one fetched part to the staging copy of its layer: sparse
        (index, value) rows through the in-place ``delta_apply`` kernel,
        chunk pages as slice copies.  The copy is a ``clone()`` of the
        serving tensor made at the layer's first part, on its device."""
        if part.layer not in self._flat:
            raise KeyError(f"delta for unknown layer {part.layer!r}")
        if self._pending_layer != part.layer:
            self._pending_layer = part.layer
            self._flat[part.layer] = self._flat[part.layer].clone()
        self._flat[part.layer] = apply_delta(self._flat[part.layer], part,
                                             donate=True)

    def _step_stage(self) -> None:
        lockstep.checkpoint("stager.stage")
        if self._fetch_thread is not None:
            # the wire transfer already happened (or is happening) on the
            # worker; a blocking get here is never slower than the
            # synchronous fetch it replaces
            kind, payload, done = self._fetch_queue.get()
            if kind == "error":
                raise payload
            if kind == "reconnect":
                # the worker exited on a dead cursor: reopen it here (the
                # sqlite-bound delta query) and restart the worker
                if not self._stop_fetch_worker():
                    raise RuntimeError(
                        "background fetch worker failed to stop during "
                        "reconnect")
                self.retry.run(self._reconnect, on_retry=self._note_retry)
                self.gw._lease_renew()
                self._start_fetch_worker()
                return
            parts = payload
        else:
            parts, done = self._fetch_parts()
        if parts:
            for part in parts:
                self._apply_part(part)
            got = int(sum(p.nbytes for p in parts))
            self.stats_["parts_applied"] += len(parts)
            self.stats_["bytes_applied"] += got
            self.stats_["max_step_bytes_applied"] = max(
                self.stats_["max_step_bytes_applied"], got)
            self._touched.update(p.layer for p in parts)
        if done:
            # ``done`` rode the queue with the final batch: the worker
            # has exited on its own, so cursor fields read from here on
            # (fetched_bytes at the flip) are past its last write
            if not self._stop_fetch_worker():
                raise RuntimeError(
                    "background fetch worker failed to stop; refusing to "
                    "flip with a live worker still writing")
            self._pending_layer = None
            # the staged tree: touched layers are the patched copies,
            # untouched leaves the client's tensors by reference
            self._staged = unflatten_like(self.gw._client.params, self._flat)
            if self.gw.quantized:
                self._requant_queue = sorted(self._touched)
                self._staged_q = self._requant_base
                self.phase = "requant"
            else:
                self._enter_prewarm()

    def _step_requant(self) -> None:
        from repro_torch.serving.quantized import (quantize_serving_params,
                                                   requantize_layers)

        if self._requant_base is None:
            # diverged gateway (see begin): full requantize, one step
            self._staged_q = quantize_serving_params(self._staged)
            self._requant_queue = []
        else:
            batch = self._requant_queue[:self.requant_layers_per_step]
            del self._requant_queue[:len(batch)]
            self._staged_q = requantize_layers(self._staged_q, self._flat,
                                               batch)
            self.stats_["layers_requantized"] += len(batch)
        if not self._requant_queue:
            self._enter_prewarm()

    def _enter_prewarm(self) -> None:
        gw = self.gw
        serving = self._staged_q if gw.quantized else self._staged
        gw._register_staging(self.to_version, serving)
        # hot tiers from scheduler occupancy, busiest first, skipping
        # tiers pending revocation, capped at the view cache's SPARE
        # slots: prewarming must never LRU-evict a view that in-flight
        # requests decode through
        spare = gw.views.capacity - len(gw.views)
        self._prewarm_queue = [
            t for t in gw.scheduler.hot_tiers()
            if not (t in gw._pending_tiers and gw._pending_tiers[t] is None)
        ][: max(0, spare)]
        self.phase = "prewarm"
        if not self._prewarm_queue:
            self.phase = "flip"

    def _step_prewarm(self) -> None:
        gw = self.gw
        if len(gw.views) >= gw.views.capacity:
            # an admission since _enter_prewarm filled the spare slots:
            # stop rather than evict a live view
            self._prewarm_queue = []
        else:
            tier = self._prewarm_queue.pop(0)
            try:
                gw.views.get(tier, self.to_version)
                self.stats_["views_prewarmed"] += 1
            except KeyError:
                pass                      # tier vanished mid-staging
        if not self._prewarm_queue:
            self.phase = "flip"

    def _flip(self) -> None:
        """Atomic install: new weights + tier redefinitions in one step."""
        gw, client = self.gw, self.gw._client
        lockstep.checkpoint("stager.flip",
                            touches=("_cursor", "_wire_bytes"))
        gw._install_staged(self.to_version)
        client.params = self._staged
        client.version = self.to_version
        client.bytes_downloaded += self._wire_bytes + self._cursor.fetched_bytes
        client.updates += 1
        self.stats_["flips"] += 1
        gw._note_sync_success(self.to_version)
        self._cursor = None
        self._staged = self._staged_q = None
        self.phase = "done"
