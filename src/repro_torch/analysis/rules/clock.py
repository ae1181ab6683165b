"""RULE-CLOCK: no bare wall-clock *calls* in serving/lease/wait math.

Every serving component takes an injectable ``clock`` (and the retry
policy an injectable ``sleep``), which is what makes frozen-clock tests
and deterministic chaos schedules possible.  A stray
``time.monotonic()`` / ``time.perf_counter()`` / ``time.time()`` /
``time.sleep()`` *call* inside the serving tree bypasses that seam.

Bare *references* stay legal — ``clock: Callable = time.perf_counter``
as a default parameter value or ``self.clock = clock or time.monotonic``
IS the injection point, so the rule only fires on call expressions.
This is what keeps the merged tree at zero suppressions: the sanctioned
sites never call, they pass the function along.

Copied from the JAX package's ``repro/analysis/rules/clock.py``: the rule
is framework-neutral.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.lint import Diagnostic, ModuleInfo
from repro_torch.analysis.rules import Rule

_CLOCK_FNS = {"monotonic", "perf_counter", "time", "monotonic_ns",
              "perf_counter_ns", "time_ns", "sleep"}

# serving/lease/wait code where wall-clock calls must flow through the
# injectable clock; offline tooling (training/, launch/) is exempt
_SCOPED_DIRS = {"serving"}
_SCOPED_FILES = {"transport.py", "protocol.py", "licensing.py"}


def _time_aliases(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    names.add(a.asname or "time")
    return names


class ClockRule(Rule):
    name = "clock"

    def applies(self, module: ModuleInfo) -> bool:
        return (any(p in _SCOPED_DIRS for p in module.parts)
                or module.name in _SCOPED_FILES)

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        if not self.applies(module):
            return []
        aliases = _time_aliases(module.tree)
        if not aliases:
            return []
        out: List[Diagnostic] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in aliases
                    and fn.attr in _CLOCK_FNS):
                d = module.diag(
                    node, self.name,
                    f"bare time.{fn.attr}() call in serving/wait math; "
                    f"route it through the injectable clock/sleep "
                    f"(e.g. self.clock())")
                if d:
                    out.append(d)
        return out
