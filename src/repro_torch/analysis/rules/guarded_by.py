"""RULE-GUARDED-BY: annotated cross-thread fields obey their guard.

The staged-sync worker (``updates.py``), the chaos transport
(``transport.py``), and the license-lease machine (``fleet.py``) share
mutable state across threads under two disciplines:

* a real lock — every touch happens inside ``with self.<lock>:``;
* single-writer ownership handed off through the bounded fetch queue
  and thread join — the field is only ever written by a known set of
  methods, and cross-thread visibility rides the queue/join barrier
  (dynamically validated by :mod:`repro_torch.analysis.lockstep`).

Fields declare which discipline protects them with a trailing comment
on their declaring assignment::

    self._counts = {}          # guarded-by: _lock
    self._cursor = None        # guarded-by: owner(begin, _reopen, abort)

Grammar: ``# guarded-by: <attr>`` names a lock attribute on the same
object — every *write* to the field elsewhere in the module must be
lexically inside ``with <obj>.<attr>:``.  ``# guarded-by:
owner(f1, f2, ...)`` lists the only functions (including any lexically
enclosing nested function) allowed to write the field.  The declaring
line itself is exempt.  The static rule checks writes; read-side safety
of owner-guarded fields is the lockstep checker's job.

Copied from the JAX package's ``repro/analysis/rules/guarded_by.py``: the rule
is framework-neutral.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.lint import Diagnostic, ModuleInfo, ancestors
from repro_torch.analysis.rules import Rule, _attr_chain

_ANNOT_RE = re.compile(r"#\s*guarded-by:\s*([^#]+?)\s*$")
_OWNER_RE = re.compile(r"owner\(([^)]*)\)")

_SCOPED_FILES = {"updates.py", "transport.py", "fleet.py"}


def _parse_annotations(module: ModuleInfo) -> Dict[str, Tuple[str, object,
                                                              int]]:
    """field name -> ("lock", lock_attr, declaring line) or
    ("owner", frozenset(names), declaring line)."""
    guards: Dict[str, Tuple[str, object, int]] = {}
    annotated: Dict[int, str] = {}
    for i, text in enumerate(module.lines, start=1):
        m = _ANNOT_RE.search(text)
        if m:
            annotated[i] = m.group(1).strip()
    if not annotated:
        return guards
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        spec = annotated.get(node.lineno)
        if spec is None:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute):
                om = _OWNER_RE.fullmatch(spec)
                if om:
                    owners = frozenset(
                        s.strip() for s in om.group(1).split(",") if s.strip())
                    guards[t.attr] = ("owner", owners, node.lineno)
                else:
                    guards[t.attr] = ("lock", spec.lstrip("self").lstrip("."),
                                      node.lineno)
    return guards


def _store_fields(node: ast.AST) -> List[ast.Attribute]:
    """Attribute stores in an assignment target (handles tuple targets)."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store):
            out.append(n)
    return out


def _under_lock(node: ast.AST, lock: str) -> bool:
    for parent in ancestors(node):
        if isinstance(parent, ast.With):
            for item in parent.items:
                chain = _attr_chain(item.context_expr)
                if chain and chain[-1] == lock:
                    return True
    return False


def _enclosing_functions(node: ast.AST) -> List[str]:
    return [p.name for p in ancestors(node)
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))]


class GuardedByRule(Rule):
    name = "guarded-by"

    def applies(self, module: ModuleInfo) -> bool:
        return (module.name in _SCOPED_FILES
                or any("guarded-by:" in ln for ln in module.lines))

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        if not self.applies(module):
            return []
        guards = _parse_annotations(module)
        if not guards:
            return []
        out: List[Diagnostic] = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                stores = _store_fields(node)
            else:
                continue
            for attr in stores:
                guard = guards.get(attr.attr)
                if guard is None:
                    continue
                kind, spec, decl_line = guard
                if node.lineno == decl_line:
                    continue                    # the declaration itself
                if kind == "lock":
                    if _under_lock(node, spec):
                        continue
                    d = module.diag(
                        node, self.name,
                        f"write to `{attr.attr}` (guarded-by: {spec}) "
                        f"outside `with ...{spec}:`")
                else:
                    encl = _enclosing_functions(node)
                    if any(fn in spec for fn in encl):
                        continue
                    where = encl[0] if encl else "<module>"
                    d = module.diag(
                        node, self.name,
                        f"write to `{attr.attr}` in `{where}` but its "
                        f"guarded-by owner set is {sorted(spec)}")
                if d:
                    out.append(d)
        return out
