"""RULE-METRICS: one metrics namespace, declared and documented.

Three schema-drift guards, promoted from the inline lint that used to
live in ``tests/test_telemetry.py`` (the runtime half — ``metrics()``
dicts vs the declared key tuples — now lives in
:mod:`repro_torch.analysis.metrics`; this rule is the *static* half over
source and docs):

* every Prometheus series name registered in ``serving/`` (string
  literals ``serving_*`` / ``fleet_*`` / ``tenant_*`` passed to
  counter/gauge/histogram registration or collector yields) must appear
  in ``docs/OBSERVABILITY.md`` — and every name the doc promises must
  exist in code, so dashboards built from the doc never query a dead
  series.  Doc names use brace groups
  (``serving_requests_{admitted,rejected}_total``) which are expanded
  before matching.
* the ``*_METRICS_KEYS`` declaration tuples in ``telemetry.py`` must be
  duplicate-free — a pasted duplicate silently weakens the
  set-difference checks built on them.
* in the counter-export table that maps ``stats()`` keys to Prometheus
  names (tuples whose second element is a series name), the source key
  must be covered by ``GATEWAY_METRICS_KEYS`` — exporting an
  undeclared key means the runtime lint can't see it.

Audit event names (``audit.record("tenant_reject", ...)``) share the
``tenant_`` prefix but are not series; ``.record`` arguments and
docstrings are excluded from collection.

Copied from the JAX package's ``repro/analysis/rules/metrics.py``: the rule
is framework-neutral.
"""
from __future__ import annotations

import ast
import os
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint import Diagnostic, ModuleInfo
from repro_torch.analysis.rules import Rule

_NAME_RE = re.compile(r"(serving|fleet|tenant)_[a-z0-9_]+")
_DOC_TOKEN_RE = re.compile(r"`([^`]+)`")
_DOC_NAME_RE = re.compile(r"(serving|fleet|tenant)_[a-z0-9_{},]+")
_DOCS_NAME = "OBSERVABILITY.md"


def _expand_braces(name: str) -> List[str]:
    m = re.search(r"\{([^{}]*)\}", name)
    if not m:
        return [name]
    out: List[str] = []
    for opt in m.group(1).split(","):
        out.extend(_expand_braces(name[:m.start()] + opt.strip()
                                  + name[m.end():]))
    return out


def _find_docs(roots: Iterable[Path]) -> Optional[Path]:
    for root in roots:
        base = root if root.is_dir() else root.parent
        for up in (base, base.parent, base.parent.parent):
            for cand in (up / "docs" / _DOCS_NAME, up / _DOCS_NAME):
                if cand.is_file():
                    return cand
    return None


def _declared_match(path: str, declared: Iterable[str]) -> bool:
    for d in declared:
        if d.endswith(".*"):
            if path == d[:-2] or path.startswith(d[:-1]):
                return True
        elif path == d:
            return True
    return False


def _code_series(module: ModuleInfo) -> Tuple[Dict[str, int], Set[str]]:
    """(series name -> first registration line, audit event names).

    Audit events share the ``tenant_`` prefix with real series; they are
    returned separately so the docs cross-check can document them in
    backticks without being flagged as dead series."""
    names: Dict[str, int] = {}
    events: Set[str] = set()
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _NAME_RE.fullmatch(node.value)):
            continue
        parent = getattr(node, "_lint_parent", None)
        if isinstance(parent, ast.Expr):
            continue                              # docstring
        if isinstance(parent, ast.Call) \
                and isinstance(parent.func, ast.Attribute) \
                and parent.func.attr == "record":
            events.add(node.value)                # audit event, not a series
            continue
        names.setdefault(node.value, node.lineno)
    return names, events


def _declared_tuples(module: ModuleInfo) -> Dict[str, Tuple[int, List[str]]]:
    """``*_METRICS_KEYS``-style tuple declarations: name -> (line, keys)."""
    out: Dict[str, Tuple[int, List[str]]] = {}
    for node in module.tree.body:
        if not (isinstance(node, (ast.Assign, ast.AnnAssign))):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        value = node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id.endswith("_KEYS") \
                    and isinstance(value, ast.Tuple):
                keys = [e.value for e in value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                out[t.id] = (node.lineno, keys)
    return out


class MetricsRule(Rule):
    name = "metrics"

    def applies(self, module: ModuleInfo) -> bool:
        return "serving" in module.parts

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        return []          # cross-module rule; see check_modules

    def check_modules(self, modules: List[ModuleInfo]) -> Iterable[Diagnostic]:
        serving = [m for m in modules if self.applies(m)]
        if not serving:
            return []
        out: List[Diagnostic] = []

        # ------------------------------------------------ declared tuples
        declared: Set[str] = set()
        for m in serving:
            if m.name != "telemetry.py":
                continue
            for tup_name, (line, keys) in _declared_tuples(m).items():
                declared.update(keys)
                seen: Set[str] = set()
                for k in keys:
                    if k in seen:
                        d = m.diag(line, self.name,
                                   f"duplicate key {k!r} in {tup_name}")
                        if d:
                            out.append(d)
                    seen.add(k)

        # ------------------------------------------------- series vs docs
        code: Dict[str, Tuple[ModuleInfo, int]] = {}
        audit_events: Set[str] = set()
        for m in serving:
            names, events = _code_series(m)
            audit_events.update(events)
            for name, line in names.items():
                code.setdefault(name, (m, line))

        docs = _find_docs({Path(m.root) for m in serving})
        if docs is not None:
            doc_names: Dict[str, int] = {}
            for i, text in enumerate(docs.read_text().splitlines(), start=1):
                for token in _DOC_TOKEN_RE.findall(text):
                    if _DOC_NAME_RE.fullmatch(token):
                        for name in _expand_braces(token):
                            doc_names.setdefault(name, i)
            docs_rel = os.path.relpath(docs)
            for name, (m, line) in sorted(code.items()):
                if name not in doc_names:
                    d = m.diag(line, self.name,
                               f"Prometheus series `{name}` is not "
                               f"documented in {docs.name}")
                    if d:
                        out.append(d)
            for name, line in sorted(doc_names.items()):
                if name not in code and name not in audit_events:
                    out.append(Diagnostic(
                        path=docs_rel, line=line, rule=self.name,
                        message=f"documented series `{name}` is not "
                                f"registered anywhere in serving/"))

        # ------------------------------- export table keys are declared
        if declared:
            for m in serving:
                for node in ast.walk(m.tree):
                    if not (isinstance(node, ast.Tuple)
                            and len(node.elts) >= 2):
                        continue
                    k, prom = node.elts[0], node.elts[1]
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and isinstance(prom, ast.Constant)
                            and isinstance(prom.value, str)
                            and _NAME_RE.fullmatch(prom.value)):
                        continue
                    if not _declared_match(k.value, declared):
                        d = m.diag(node, self.name,
                                   f"stats key {k.value!r} exported as "
                                   f"`{prom.value}` is not declared in any "
                                   f"*_METRICS_KEYS tuple")
                        if d:
                            out.append(d)
        return out
