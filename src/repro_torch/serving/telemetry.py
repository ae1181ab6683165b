"""Serving-wide metrics registry of the port: counters, gauges,
fixed-bucket histograms.

A copy of ``repro/serving/telemetry.py`` (the JAX package's registry is
pure Python, but importing it would import JAX): the same instruments,
the same bucket edges, the same Prometheus text and the same declared
``metrics()`` schemas, so one dashboard and one scrape config serve both
packages.

* :class:`Counter` — monotone event count.  Most serving counters are
  *pull*-backed (``fn=``): the hot path keeps bumping its plain
  ``stats`` dict and the counter reads it at export time, so
  instrumentation adds **zero** cost to the paths it observes.
* :class:`Gauge` — instantaneous level (pool occupancy, queue depth),
  normally ``fn``-backed for the same reason.
* :class:`Histogram` — fixed-bucket latency distribution with
  ``p50``/``p90``/``p99`` accessors.  ``observe`` is O(log buckets)
  (a bisect + one bincount bump), the only *push*-model instrument —
  the always-on cost that telemetry adds to a decode step.
* :class:`Telemetry` — the registry: get-or-create instruments keyed by
  ``(name, labels)``, dynamic-label *collectors* (per-tenant series
  whose label set is unknown at registration), a structured
  :meth:`~Telemetry.snapshot`, and Prometheus text exposition via
  :meth:`~Telemetry.render_prometheus`.

Every instrument family renders once (``# HELP``/``# TYPE`` headers
deduplicated across label sets); each slot labels its instruments
``{"model": name}``.

``GATEWAY_METRICS_KEYS``/``FLEET_METRICS_KEYS`` are the declared
``metrics()`` schemas, verbatim from the JAX package:
:func:`validate_gateway_metrics` flattens live ``metrics()`` output into
dotted paths and rejects any key not declared here, so ad-hoc
unregistered keys cannot silently appear.

Everything is injectable-clock (``clock=``) and has an ``enabled``
switch: ``enabled=False`` turns every push-path record into an early
return (a gateway built with ``telemetry=False``).
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "Counter", "Gauge", "Histogram", "Telemetry",
    "DEFAULT_LATENCY_BUCKETS", "GATEWAY_METRICS_KEYS", "FLEET_METRICS_KEYS",
    "FLEET_MODEL_EXTRA_KEYS",
    "flatten_metric_keys",
    "validate_gateway_metrics", "validate_fleet_metrics",
]

# Seconds.  Sub-100µs steps up through minute-scale queue waits; chosen
# once so every latency histogram (TTFT, inter-token gap, queue wait,
# step duration, stager stall) shares comparable bucket edges.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _render_labels(labels: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotone counter.  ``fn``-backed counters read an external value
    at export time (zero hot-path cost); push counters use :meth:`inc`."""

    kind = "counter"
    __slots__ = ("name", "labels", "help", "_value", "_fn")

    def __init__(self, name: str, labels: LabelKey = (), help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0
        self._fn = fn

    def inc(self, n: float = 1) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._value


class Gauge:
    """Instantaneous level.  ``fn``-backed (evaluated at export) or
    :meth:`set` directly."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "_value", "_fn")

    def __init__(self, name: str, labels: LabelKey = (), help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._value


class Histogram:
    """Fixed-bucket histogram with percentile accessors.

    ``observe`` is a bisect over the (static) upper edges plus one
    counter bump — O(log buckets), no allocation — cheap enough to sit
    on the decode emit path.  Percentiles interpolate linearly inside
    the winning bucket (the +Inf bucket reports the last finite edge),
    which is the standard Prometheus ``histogram_quantile`` estimate
    computed client-side.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "help", "buckets", "counts", "sum",
                 "count", "enabled")

    def __init__(self, name: str, buckets: Sequence[float] =
                 DEFAULT_LATENCY_BUCKETS, labels: LabelKey = (),
                 help: str = "", enabled: bool = True):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing: {buckets}")
        self.name = name
        self.labels = labels
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.enabled = enabled

    def observe(self, v: float) -> None:
        if not self.enabled:
            return
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, p: float) -> float:
        """Interpolated percentile, 0 <= p <= 100; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else 0.0
            hi = (self.buckets[i] if i < len(self.buckets)
                  else self.buckets[-1])
            if cum + c >= rank:
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += c
        return self.buckets[-1]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p90(self) -> float:
        return self.percentile(90)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "p50": self.p50,
                "p90": self.p90, "p99": self.p99}


class Telemetry:
    """The registry: get-or-create instruments, snapshot, exposition.

    One ``Telemetry`` can be shared across serving layers (a fleet
    shares one across all model slots; each slot labels its instruments
    ``{"model": ...}``).  ``enabled=False`` disables every *push*
    instrument created through this registry (histogram observes become
    no-ops) — pull-backed counters/gauges are free either way.
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self.clock = clock
        self.enabled = bool(enabled)
        # insertion-ordered: families render in registration order
        self._instruments: "Dict[Tuple[str, LabelKey], Any]" = {}
        self._collectors: List[Callable[[], Iterable[Tuple]]] = []
        self._declared: set = set()

    # ------------------------------------------------------------ instruments
    def _get(self, cls, name: str, labels, help: str, **kw):
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, labels=key[1], help=help, **kw)
            self._instruments[key] = inst
        elif not isinstance(inst, cls):
            raise ValueError(f"instrument {name!r} already registered as "
                             f"{inst.kind}")
        return inst

    def counter(self, name: str, *, labels: Optional[Dict[str, str]] = None,
                help: str = "",
                fn: Optional[Callable[[], float]] = None) -> Counter:
        return self._get(Counter, name, labels, help, fn=fn)

    def gauge(self, name: str, *, labels: Optional[Dict[str, str]] = None,
              help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get(Gauge, name, labels, help, fn=fn)

    def histogram(self, name: str, *,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  labels: Optional[Dict[str, str]] = None,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets,
                         enabled=self.enabled)

    def register_collector(
            self, fn: Callable[[], Iterable[Tuple]]) -> None:
        """Register a dynamic-series source evaluated at export time.

        ``fn`` yields ``(name, kind, help, labels_dict, value)`` tuples —
        the escape hatch for label sets unknown at registration (e.g.
        one gauge per live tenant)."""
        self._collectors.append(fn)

    def adopt(self, other: "Telemetry") -> None:
        """Merge another registry's instruments and collectors into this
        one (fleet ``attach`` of a standalone gateway).  Colliding
        (name, labels) keys are an error — slots are label-disjoint by
        model name, so a collision means two slots claimed one series."""
        if other is self:
            return
        for key, inst in other._instruments.items():
            if key in self._instruments:
                raise ValueError(f"instrument collision on adopt: {key}")
            self._instruments[key] = inst
        self._collectors.extend(other._collectors)
        self._declared |= other._declared

    # ---------------------------------------------------------- metrics() lint
    def declare(self, *paths: str) -> None:
        """Declare ``metrics()`` key paths as registered (see
        :func:`repro_torch.analysis.metrics.unregistered_metric_keys`)."""
        self._declared.update(paths)

    @property
    def declared(self) -> frozenset:
        return frozenset(self._declared)

    # -------------------------------------------------------------- snapshot
    def _families(self) -> "Dict[str, List[Any]]":
        fams: "Dict[str, List[Any]]" = {}
        for inst in self._instruments.values():
            fams.setdefault(inst.name, []).append(inst)
        for coll in self._collectors:
            for name, kind, help_, labels, value in coll():
                inst = (Counter if kind == "counter" else Gauge)(
                    name, labels=_label_key(labels), help=help_)
                inst._value = value
                fams.setdefault(name, []).append(inst)
        return fams

    def snapshot(self) -> Dict[str, Any]:
        """Structured-JSON view of every registered series."""
        out: Dict[str, Any] = {}
        for name, insts in self._families().items():
            fam = {"type": insts[0].kind, "help": insts[0].help, "series": []}
            for inst in insts:
                series: Dict[str, Any] = {"labels": dict(inst.labels)}
                if inst.kind == "histogram":
                    series.update(inst.summary())
                    series["buckets"] = [
                        {"le": le, "count": c}
                        for le, c in zip(list(inst.buckets) + ["+Inf"],
                                         inst.counts)]
                else:
                    series["value"] = inst.value
                fam["series"].append(series)
            out[name] = fam
        return out

    # ------------------------------------------------------------- prometheus
    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) for every series."""
        lines: List[str] = []
        for name, insts in self._families().items():
            if insts[0].help:
                lines.append(f"# HELP {name} {insts[0].help}")
            lines.append(f"# TYPE {name} {insts[0].kind}")
            for inst in insts:
                if inst.kind == "histogram":
                    cum = 0
                    for le, c in zip(list(inst.buckets) + [math.inf],
                                     inst.counts):
                        cum += c
                        le_s = "+Inf" if le == math.inf else repr(float(le))
                        le_lbl = 'le="' + le_s + '"'
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(inst.labels, le_lbl)} {cum}")
                    lines.append(f"{name}_sum{_render_labels(inst.labels)}"
                                 f" {inst.sum}")
                    lines.append(f"{name}_count{_render_labels(inst.labels)}"
                                 f" {inst.count}")
                else:
                    v = inst.value
                    v_s = repr(float(v)) if isinstance(v, float) else str(v)
                    lines.append(
                        f"{name}{_render_labels(inst.labels)} {v_s}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------- metrics() schemas
# The declared key schema of LicensedGateway.metrics().  ``.*`` marks a
# map with dynamic keys (tier names, tenant names, bucket widths); the
# lint test accepts any leaf under it.  A NEW metrics() key must be
# added here (and documented in docs/OBSERVABILITY.md) or the lint test
# fails — that is the point: no unregistered ad-hoc keys.
GATEWAY_METRICS_KEYS: Tuple[str, ...] = (
    # flat counters (ModelSlot.stats)
    "admitted", "rejected", "completed", "prefill_batches", "decode_steps",
    "resident_decode_steps", "tokens_generated", "preempted", "max_running",
    "max_blocks_in_use", "prefill_lane_tokens", "prefix_tokens_reused",
    "cow_copies", "prefill_chunks", "quota_rejections",
    "sync_retries", "sync_timeouts", "sync_quarantines",
    "model",
    # nested sections
    "view_cache.hits", "view_cache.misses", "view_cache.evictions",
    "view_cache.invalidations", "view_cache.entries",
    "oldest_wait_s", "queue_wait_by_tier.*", "tenants.*",
    "cache_pool.*", "decode_path.kernel_resident", "decode_path.pallas",
    "staged_update.*", "lease.*",
    "chunked_prefill.enabled", "chunked_prefill.chunk_size",
    "chunked_prefill.chunks",
    "admission_grouping.enabled", "admission_grouping.batches_by_suffix_width.*",
    "prefix_cache.*",
    # completion-latency percentiles (present once >= 1 request completed)
    "latency_p50_ms", "latency_p99_ms",
    # telemetry histograms (always present): p50/p90/p99/count/sum per axis
    "latency.ttft_s.*", "latency.inter_token_s.*", "latency.queue_wait_s.*",
    "latency.step_prefill_s.*", "latency.step_decode_s.*",
    "latency.stager_step_s.*",
)

# Fleet-section schema; each models.<name> section is the single-gateway
# schema above plus the fleet extensions listed here.
FLEET_METRICS_KEYS: Tuple[str, ...] = (
    "fleet.models", "fleet.steps", "fleet.cache_budget_bytes",
    "fleet.cache_used_bytes", "fleet.cache_reclaimable_bytes",
    "fleet.tokens_generated", "fleet.completed", "fleet.quota_rejections",
    "fleet.oldest_wait_s",
    "tenants.*",
)

# keys a fleet adds ON TOP of the single-gateway schema in models.<name>
FLEET_MODEL_EXTRA_KEYS: Tuple[str, ...] = ("tokens_per_s",)


def flatten_metric_keys(d: Any, prefix: str = "") -> List[str]:
    """Dotted leaf paths of a nested metrics dict."""
    if not isinstance(d, dict):
        return [prefix] if prefix else []
    if not d:
        return [prefix] if prefix else []
    out: List[str] = []
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        out.extend(flatten_metric_keys(v, path))
    return out


def validate_gateway_metrics(metrics: Dict[str, Any],
                             extra: Iterable[str] = ()) -> None:
    """Assert ``metrics`` carries exactly the single-gateway schema.

    Checks both directions: no unregistered keys (modulo ``extra``, the
    fleet's documented per-model additions), and every non-wildcard,
    non-conditional declared key present — the schema-drift guard shared
    by the standalone-gateway test and the fleet per-model test.  The
    set-difference primitives live in :mod:`repro_torch.analysis.metrics`
    (imported lazily: analysis depends on this module for
    ``flatten_metric_keys``)."""
    from repro_torch.analysis.metrics import (missing_metric_keys,
                                        unregistered_metric_keys)

    unknown = unregistered_metric_keys(
        metrics, list(GATEWAY_METRICS_KEYS) + list(extra))
    assert not unknown, f"unregistered metrics() keys: {unknown}"
    missing = missing_metric_keys(
        metrics, GATEWAY_METRICS_KEYS,
        # conditional keys and configuration-dependent sections
        optional=("latency_p50_ms", "latency_p99_ms", "tenants.",
                  "queue_wait_by_tier.",
                  "admission_grouping.batches_by_suffix_width.*"))
    assert not missing, f"metrics() keys missing from schema: {missing}"


def validate_fleet_metrics(metrics: Dict[str, Any],
                           extra: Iterable[str] = ()) -> None:
    """Assert the fleet ``metrics()`` schema — including the unification
    guarantee: every ``models.<name>`` section passes the EXACT
    single-gateway check (plus the documented fleet extras, and
    ``extra``: the port's ``decode_path.kernels``), so one
    dashboard/parser serves standalone and fleet deployments alike."""
    from repro_torch.analysis.metrics import (missing_metric_keys,
                                        unregistered_metric_keys)

    assert set(metrics) == {"fleet", "models", "tenants"}, \
        f"fleet metrics sections: {sorted(metrics)}"
    unknown = unregistered_metric_keys(
        {"fleet": metrics["fleet"], "tenants": metrics["tenants"]},
        FLEET_METRICS_KEYS)
    assert not unknown, f"unregistered fleet metrics() keys: {unknown}"
    missing = missing_metric_keys(
        {"fleet": metrics["fleet"]},
        [d for d in FLEET_METRICS_KEYS if not d.endswith(".*")])
    assert not missing, f"fleet metrics() keys missing: {missing}"
    for name, m in metrics["models"].items():
        validate_gateway_metrics(m, extra=FLEET_MODEL_EXTRA_KEYS + tuple(extra))
        for k in FLEET_MODEL_EXTRA_KEYS:
            assert k in m, f"models[{name!r}] missing fleet extra {k!r}"
