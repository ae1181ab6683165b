"""Deterministic lockstep scheduler for the staged-sync thread pair.

A copy of ``repro/analysis/lockstep.py`` (the port's ``UpdateStager``
runs the same worker/serving protocol and calls the same hooks).

The update stager runs one background fetch worker against the serving
thread, sharing cursor state under a single-writer ownership protocol
(the ``# guarded-by: owner(...)`` annotations checked statically by
RULE-GUARDED-BY).  This module validates the *dynamic* half: under a
:class:`LockstepScheduler`, annotated code paths call
:func:`checkpoint` with the fields they are about to touch, and the
scheduler

* asserts the calling thread's role currently owns every touched field
  (ownership moves with :func:`transfer_ownership`, placed exactly where
  the real protocol moves it: worker spawn and post-join), raising
  :class:`LockstepViolation` at the first wrong-thread touch;
* *perturbs* the interleaving deterministically — per (checkpoint,
  visit#) it decides by seeded hash whether to pause the caller until
  another thread reaches a checkpoint, the same decision scheme
  ChaosTransport uses per (op, call#), so a failing seed replays.

Pauses are bounded (``max_pause_s``) and waiting never holds a lock the
other thread needs, so the harness cannot deadlock the bounded fetch
queue — a pause expires into a plain resume.  Outside a ``with
LockstepScheduler(...)`` block every hook is a no-op costing one global
read, so instrumented production code pays nothing.

This module is intentionally import-free of the rest of ``repro_torch``
so low-level serving modules can instrument themselves without cycles.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["LockstepViolation", "LockstepScheduler", "checkpoint",
           "transfer_ownership", "active"]

_ACTIVE: Optional["LockstepScheduler"] = None

_WORKER_PREFIX = "update-stager"


class LockstepViolation(RuntimeError):
    """A thread touched a field whose ownership it does not hold."""


def active() -> Optional["LockstepScheduler"]:
    return _ACTIVE


def checkpoint(name: str, touches: Iterable[str] = ()) -> None:
    """Annotated yield point: declare the fields this code path is about
    to touch, and give the lockstep scheduler (when one is active) a
    place to check ownership and perturb the interleaving."""
    sched = _ACTIVE
    if sched is not None:
        sched._visit(name, tuple(touches))


def transfer_ownership(fields: Iterable[str], role: str) -> None:
    """Record that ``fields`` are now owned by ``role`` ("serve" or
    "worker").  Placed at the protocol's real handoff points: before the
    fetch worker starts, and after the serving thread joins it."""
    sched = _ACTIVE
    if sched is not None:
        sched._transfer(tuple(fields), role)


def _role() -> str:
    name = threading.current_thread().name
    return "worker" if name.startswith(_WORKER_PREFIX) else "serve"


class LockstepScheduler:
    """Context manager arming the checkpoints (one active at a time)."""

    def __init__(self, seed: int = 0, switch_rate: float = 0.5,
                 max_pause_s: float = 0.02) -> None:
        self.seed = int(seed)
        self.switch_rate = float(switch_rate)
        self.max_pause_s = float(max_pause_s)
        self._cond = threading.Condition()
        self._counts: Dict[str, int] = {}
        self._gen = 0
        self.visits: Dict[str, int] = {}
        self.pauses = 0
        self.violations: List[str] = []
        self._owners: Dict[str, str] = {}
        self.transfers: List[Tuple[str, Tuple[str, ...]]] = []

    # ------------------------------------------------------------ hooks
    def _transfer(self, fields: Tuple[str, ...], role: str) -> None:
        with self._cond:
            for f in fields:
                self._owners[f] = role
            self.transfers.append((role, fields))

    def _visit(self, name: str, touches: Tuple[str, ...]) -> None:
        role = _role()
        with self._cond:
            for f in touches:
                owner = self._owners.get(f)
                if owner is not None and owner != role:
                    msg = (f"checkpoint {name!r}: thread role {role!r} "
                           f"touches {f!r} owned by {owner!r}")
                    self.violations.append(msg)
                    self._gen += 1
                    self._cond.notify_all()
                    raise LockstepViolation(msg)
            n = self._counts.get(name, 0)
            self._counts[name] = n + 1
            self.visits[name] = self.visits.get(name, 0) + 1
            # the ChaosTransport decision scheme: one hash per
            # (checkpoint, visit#) — same seed, same schedule pressure
            h = zlib.crc32(f"{self.seed}:{name}:{n}".encode())
            pause = (h % 1000) / 1000.0 < self.switch_rate
            self._gen += 1
            self._cond.notify_all()
            if pause:
                self.pauses += 1
                gen = self._gen
                # bounded: resumes when any other thread checkpoints, or
                # on timeout — never deadlocks the bounded fetch queue
                self._cond.wait_for(lambda: self._gen != gen,
                                    timeout=self.max_pause_s)

    # ---------------------------------------------------------- context
    def __enter__(self) -> "LockstepScheduler":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a LockstepScheduler is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None
