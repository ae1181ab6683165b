"""Request lifecycle tracing, Chrome trace_event export, licensing audit.

A copy of ``repro/serving/tracing.py`` (pure Python; importing the JAX
package's module would import JAX), so both packages record the same
events under the same names and export the same Chrome JSON.  Three
pieces, all zero-dependency and always-on cheap:

* :class:`TraceRecorder` — per-gateway event tape.  Every record is one
  O(1) append of a plain tuple ``(ts, kind, rid, name, attrs)`` onto a
  bounded deque; no dict churn, no string formatting on the hot path.
  The span taxonomy (``docs/OBSERVABILITY.md``) covers the full request
  lifecycle: ``submit → admit → prefix_hit → prefill_chunk×N →
  decode_step×M → preempt/restart → finish``, plus scheduler actions
  and stager phases as instant/complete events and pool occupancy as
  counter samples.
* Chrome ``trace_event`` export — :meth:`TraceRecorder.chrome_trace`
  renders the tape into the JSON Array Format that Perfetto /
  ``chrome://tracing`` load directly: request spans as matched ``B``/``E``
  pairs (one tid per request), scheduler actions and stager phases as
  ``X`` complete events on pseudo-threads, occupancy as ``C`` counter
  tracks, and ``M`` metadata naming every track.  A fleet merges slot
  tapes with one *pid per model*.
* :class:`AuditLog` — the licensing ledger: append-only
  ``(ts, seq, event, attrs)`` records for tier grants/revocations,
  view-cache materializations, version installs/flips, and per-tenant
  quota/rate rejections — "who could run which tier at which version
  when", answerable after the fact.

:func:`validate_chrome_trace` is the acceptance check the tests and
``chip_smoke.py`` share: parseable JSON, non-decreasing timestamps, and
balanced ``B``/``E`` pairs per (pid, tid).
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple)

__all__ = ["TraceRecorder", "AuditLog", "validate_chrome_trace",
           "merge_chrome_traces", "SCHED_TID", "STAGER_TID"]

# Span kinds (ph in the Chrome mapping):
#   "B"/"E"  span begin/end          (per-request lifecycle phases)
#   "i"      instant                 (submit, admit, prefix_hit, preempt, ...)
#   "X"      complete w/ duration    (scheduler action, stager phase)
#   "C"      counter sample          (pool occupancy, queue depth)

SCHED_TID = 0           # pseudo-thread for scheduler actions
STAGER_TID = 1          # pseudo-thread for stager phases
_COUNTER_TID = 2        # counters hang off the process track
_RID_TID_BASE = 10      # request rid r -> tid 10 + r


class TraceRecorder:
    """Bounded per-gateway event tape with Chrome trace_event export.

    ``record*`` methods are the only hot-path surface: one tuple append
    each, guarded by ``enabled``.  Everything else (per-request slicing,
    Chrome JSON rendering) walks the tape at export time.
    """

    __slots__ = ("clock", "enabled", "events", "_t0")

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True, maxlen: int = 200_000):
        self.clock = clock
        self.enabled = bool(enabled)
        # (ts, ph, rid, name, attrs_or_None, dur_or_value)
        self.events: "deque[Tuple]" = deque(maxlen=maxlen)
        self._t0 = clock()

    # ------------------------------------------------------------- recording
    def instant(self, name: str, rid: int = -1,
                attrs: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.events.append((self.clock(), "i", rid, name, attrs, None))

    def begin(self, name: str, rid: int,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.events.append((self.clock(), "B", rid, name, attrs, None))

    def end(self, name: str, rid: int,
            attrs: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.events.append((self.clock(), "E", rid, name, attrs, None))

    def complete(self, name: str, start: float, end: float, *,
                 tid: int = SCHED_TID,
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        """X event with explicit duration, on a pseudo-thread track."""
        if not self.enabled:
            return
        self.events.append((start, "X", -1 - tid, name, attrs, end - start))

    def counter(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.events.append((self.clock(), "C", -1, name, None, value))

    # --------------------------------------------------------------- queries
    def request_events(self, rid: int) -> List[Dict[str, Any]]:
        """Chronological event dicts for one request (its lifecycle story)."""
        out = []
        for ts, ph, erid, name, attrs, _ in self.events:
            if erid == rid:
                out.append({"ts": ts, "ph": ph, "name": name,
                            "attrs": dict(attrs) if attrs else {}})
        return out

    def span_names(self, rid: int) -> List[str]:
        return [e["name"] for e in self.request_events(rid)]

    # ---------------------------------------------------------- chrome export
    def chrome_events(self, *, pid: int = 1,
                      process_name: str = "gateway",
                      t0: Optional[float] = None) -> List[Dict[str, Any]]:
        """Raw trace_event dicts (ts in µs, relative to recorder start;
        pass ``t0`` to align several recorders on one timebase)."""
        t0 = self._t0 if t0 is None else t0
        ev: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": process_name}},
            {"ph": "M", "pid": pid, "tid": SCHED_TID,
             "name": "thread_name", "args": {"name": "scheduler"}},
            {"ph": "M", "pid": pid, "tid": STAGER_TID,
             "name": "thread_name", "args": {"name": "stager"}},
        ]
        named_rids = set()
        open_spans: Dict[Tuple[int, str], int] = {}   # (rid, name) -> count
        for ts, ph, rid, name, attrs, extra in sorted(
                self.events, key=lambda e: e[0]):
            us = max(0.0, (ts - t0) * 1e6)
            args = dict(attrs) if attrs else {}
            if ph == "C":
                ev.append({"ph": "C", "pid": pid, "tid": _COUNTER_TID,
                           "name": name, "ts": us, "args": {"value": extra}})
                continue
            if ph == "X":
                tid = -1 - rid          # complete() encodes tid as -1-tid
                ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                           "ts": us, "dur": max(0.0, extra * 1e6),
                           "args": args})
                continue
            tid = _RID_TID_BASE + rid if rid >= 0 else SCHED_TID
            if rid >= 0 and rid not in named_rids:
                named_rids.add(rid)
                ev.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"request {rid}"}})
            if ph == "B":
                open_spans[(rid, name)] = open_spans.get((rid, name), 0) + 1
            elif ph == "E":
                if open_spans.get((rid, name), 0) <= 0:
                    continue            # unmatched E: drop, keep trace valid
                open_spans[(rid, name)] -= 1
            ev.append({"ph": ph, "pid": pid, "tid": tid, "name": name,
                       "ts": us, "args": args})
            if ph == "i":
                ev[-1]["s"] = "t"       # instant scope: thread
        # Close any still-open span (request mid-flight at export) at the
        # tape's last timestamp so every B has a matching E.
        last_us = max((e["ts"] for e in ev if "ts" in e), default=0.0)
        for (rid, name), n in open_spans.items():
            for _ in range(n):
                ev.append({"ph": "E", "pid": pid,
                           "tid": _RID_TID_BASE + rid, "name": name,
                           "ts": last_us, "args": {}})
        return ev

    def chrome_trace(self, *, pid: int = 1,
                     process_name: str = "gateway") -> str:
        """Whole-tape timeline as Chrome trace_event JSON (array format)."""
        return json.dumps(self.chrome_events(pid=pid,
                                             process_name=process_name))


def merge_chrome_traces(
        tapes: Iterable[Tuple[str, "TraceRecorder"]]) -> str:
    """Merge named recorders into one trace — one pid per model/slot,
    all aligned on the earliest recorder's timebase."""
    tapes = list(tapes)
    t0 = min((rec._t0 for _, rec in tapes), default=0.0)
    ev: List[Dict[str, Any]] = []
    for pid, (name, rec) in enumerate(tapes, start=1):
        ev.extend(rec.chrome_events(pid=pid, process_name=name, t0=t0))
    return json.dumps(ev)


class AuditLog:
    """Append-only licensing ledger.

    Events: ``tier_grant``, ``tier_revoke``, ``tier_redefine``,
    ``view_materialize``, ``version_install``, ``version_flip``,
    ``sync_begin``, ``sync_abort``, ``sync_retry``, ``sync_quarantine``,
    ``lease_degraded``, ``lease_offline``, ``lease_restored``,
    ``quota_reject``, ``rate_reject``, ``tenant_reject``.  Each record
    is ``(ts, seq, event, attrs)`` — one tuple append, no formatting
    until export.  ``record`` is safe from the background fetch worker:
    the deque append and the itertools counter are both atomic.
    """

    __slots__ = ("clock", "enabled", "records", "_seq")

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True, maxlen: int = 100_000):
        self.clock = clock
        self.enabled = bool(enabled)
        self.records: "deque[Tuple[float, int, str, Dict]]" = \
            deque(maxlen=maxlen)
        self._seq = itertools.count()

    def record(self, event: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        self.records.append((self.clock(), next(self._seq), event, attrs))

    def events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        out = []
        for ts, seq, ev, attrs in self.records:
            if event is not None and ev != event:
                continue
            out.append({"ts": ts, "seq": seq, "event": ev, **attrs})
        return out

    def render_jsonl(self) -> str:
        return "\n".join(json.dumps(e, default=str)
                         for e in self.events()) + "\n"

    @staticmethod
    def merge(logs: Iterable["AuditLog"]) -> List[Dict[str, Any]]:
        """Fleet-wide view: merged records ordered by (ts, seq)."""
        out: List[Dict[str, Any]] = []
        for log in logs:
            out.extend(log.events())
        out.sort(key=lambda e: (e["ts"], e["seq"]))
        return out


def validate_chrome_trace(text: str) -> List[Dict[str, Any]]:
    """Assert ``text`` is valid Chrome trace_event JSON; return events.

    Checks the acceptance-criteria triple: parseable, per-track
    non-decreasing timestamps, and matched B/E nesting per (pid, tid).
    Raises ``ValueError`` on any violation.
    """
    events = json.loads(text)
    if not isinstance(events, list):
        raise ValueError("trace must be a JSON array of events")
    last_ts: Dict[Tuple[int, int], float] = {}
    stacks: Dict[Tuple[int, int], List[str]] = {}
    for e in events:
        if not isinstance(e, dict) or "ph" not in e:
            raise ValueError(f"malformed event: {e!r}")
        ph = e["ph"]
        if ph == "M":
            continue
        key = (e.get("pid", 0), e.get("tid", 0))
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event missing/invalid ts: {e!r}")
        if ts < last_ts.get(key, 0.0):
            raise ValueError(
                f"timestamps not monotonic on track {key}: "
                f"{ts} < {last_ts[key]} at {e!r}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif ph == "E":
            stack = stacks.get(key, [])
            if not stack:
                raise ValueError(f"unmatched E event on track {key}: {e!r}")
            stack.pop()
    open_tracks = {k: v for k, v in stacks.items() if v}
    if open_tracks:
        raise ValueError(f"unclosed B spans at end of trace: {open_tracks}")
    return events
