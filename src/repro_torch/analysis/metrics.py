"""Runtime metrics-schema checking of the port (a copy of
``repro/analysis/metrics.py``; the dynamic half of RULE-METRICS).

A ``metrics()`` dict is valid when every dotted leaf path is covered by
the declared key schema (``GATEWAY_METRICS_KEYS`` /
``FLEET_METRICS_KEYS`` in :mod:`repro_torch.serving.telemetry`) — ``.*``
entries accept any leaf under a dynamic section (tier names, tenant
names, bucket widths).  This module owns the set-difference primitives;
``telemetry.validate_gateway_metrics`` / ``validate_fleet_metrics``
build their assertions on top of them, and the schema tests call
:func:`unregistered_metric_keys` directly.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

__all__ = ["declared_match", "unregistered_metric_keys",
           "missing_metric_keys"]


def declared_match(path: str, declared: Iterable[str]) -> bool:
    """True when leaf ``path`` is covered by one declared key.

    A declared key ``a.b.*`` covers ``a.b`` itself and any leaf below
    it; anything else must match exactly."""
    for d in declared:
        if d.endswith(".*"):
            if path == d[:-2] or path.startswith(d[:-1]):
                return True
        elif path == d:
            return True
    return False


def unregistered_metric_keys(metrics: Dict[str, Any],
                             declared: Iterable[str]) -> List[str]:
    """Leaf paths of ``metrics`` not covered by the declared schema."""
    from repro_torch.serving.telemetry import flatten_metric_keys

    declared = list(declared)
    return [p for p in flatten_metric_keys(metrics)
            if not declared_match(p, declared)]


def missing_metric_keys(metrics: Dict[str, Any],
                        declared: Iterable[str],
                        optional: Iterable[str] = ()) -> List[str]:
    """Declared keys with no witness in ``metrics`` (the reverse
    direction): an exact key must be present as a leaf, a ``.*`` key
    needs at least one leaf under its stem.  Keys in ``optional`` (and
    prefixes ending in ``.``) are configuration-dependent and skipped."""
    from repro_torch.serving.telemetry import flatten_metric_keys

    flat = set(flatten_metric_keys(metrics))
    optional = list(optional)

    def _optional(decl: str) -> bool:
        return any(decl == o or (o.endswith(".") and decl.startswith(o))
                   for o in optional)

    def _present(decl: str) -> bool:
        if decl.endswith(".*"):
            stem = decl[:-2]
            return any(p == stem or p.startswith(stem + ".") for p in flat)
        return decl in flat

    return [d for d in declared if not _optional(d) and not _present(d)]
