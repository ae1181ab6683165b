"""RULE-OBS: telemetry/trace/audit record sites stay behind ``self.obs``.

The observability layer's <3% overhead gate (docs/OBSERVABILITY.md)
holds because every *record* call in the serving hot path — span
begin/end/instant/complete/counter on a tracer, ``audit.record``, and
histogram ``observe`` — is guarded by one pre-computed ``obs`` bool, so
a ``telemetry=False`` gateway never builds attribute dicts or touches
the tape.  This rule flags any record site in ``serving/`` that is not
lexically under an ``obs`` guard.

Read-side exports (``chrome_trace``, ``span_names``, ``events``,
``render_*``) are not record sites, and the instrument *implementations*
(``telemetry.py`` / ``tracing.py``) are exempt — the guard lives at the
call site, not inside the instrument.

Recognized guards: an enclosing ``if <...>.obs:`` (or ``and``-compound)
statement/ternary with the site on the true branch, or an early
``if not <...>.obs: return`` at the top level of the enclosing function.

Copied from the JAX package's ``repro/analysis/rules/obs.py``: the rule
is framework-neutral.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.lint import Diagnostic, ModuleInfo, ancestors
from repro_torch.analysis.rules import Rule, _attr_chain

_TRACER_METHODS = {"begin", "end", "instant", "complete", "counter"}
_EXEMPT_FILES = {"telemetry.py", "tracing.py"}
_OBS_ONLY = frozenset({"obs"})
_OBS_AND_AUDIT = frozenset({"obs", "audit"})


def _mentions(test: ast.AST, names: frozenset) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in names:
            return True
        if isinstance(n, ast.Name) and n.id in names:
            return True
    return False


def _in_true_branch(parent: ast.AST, child: ast.AST) -> bool:
    if isinstance(parent, ast.If):
        return child in parent.body or child is parent.test
    if isinstance(parent, ast.IfExp):
        return child is parent.body or child is parent.test
    return False


def _guarded(node: ast.AST, guard_names: frozenset) -> bool:
    child: ast.AST = node
    func = None
    for parent in ancestors(node):
        if isinstance(parent, (ast.If, ast.IfExp)) \
                and _mentions(parent.test, guard_names) \
                and _in_true_branch(parent, child):
            return True
        if func is None and isinstance(
                parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = parent
            # early-out guard: ``if not self.obs: return`` before the site
            for stmt in func.body:
                if stmt.lineno >= node.lineno:
                    break
                if (isinstance(stmt, ast.If) and not stmt.orelse
                        and isinstance(stmt.test, ast.UnaryOp)
                        and isinstance(stmt.test.op, ast.Not)
                        and _mentions(stmt.test.operand, guard_names)
                        and all(isinstance(s, (ast.Return, ast.Raise))
                                for s in stmt.body)):
                    return True
        child = parent
    return False


def _is_record_site(node: ast.Call) -> str:
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return ""
    if fn.attr == "observe":
        return "histogram observe"
    chain = _attr_chain(fn)
    if fn.attr in _TRACER_METHODS and "tracer" in chain[:-1]:
        return f"tracer.{fn.attr}"
    if fn.attr == "record" and "audit" in chain[:-1]:
        return "audit.record"
    return ""


class ObsRule(Rule):
    name = "obs"

    def applies(self, module: ModuleInfo) -> bool:
        return ("serving" in module.parts
                and module.name not in _EXEMPT_FILES)

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        if not self.applies(module):
            return []
        out: List[Diagnostic] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _is_record_site(node)
            if not kind:
                continue
            # an audit site may also be guarded by the optional-audit
            # idiom ``if self.audit is not None:`` (registries that have
            # no obs flag and receive the log by injection)
            names = (_OBS_AND_AUDIT if kind == "audit.record"
                     else _OBS_ONLY)
            if _guarded(node, names):
                continue
            d = module.diag(
                node, self.name,
                f"unguarded {kind} record site; wrap it in "
                f"`if self.obs:` so telemetry=False serving pays nothing")
            if d:
                out.append(d)
        return out
