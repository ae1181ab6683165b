"""RULE-KERNEL: every hand-written kernel is paired, bound and never hidden.

The port's kernel contract (``kernels/ref.py``, ``kernels/build.py``):
each wrapper that launches a CUDA kernel through the extension that
``build.load_extension()`` compiles from ``csrc/`` has a plain PyTorch
version of the same name in ``ref.py`` (the CPU path and the oracle the
tests and ``chip_smoke.py`` hold it against); every function that
``csrc/bindings.cpp`` binds with ``m.def("name", ...)`` is reached by a
wrapper; and a kernel that fails on the card raises — no wrapper catches
the failure and quietly serves the plain version or the CPU instead.

Checks, per module under ``kernels/`` (``ref.py``, ``ops.py``,
``build.py`` and ``__init__.py`` are exempt):

* every public top-level function whose body calls ``load_extension``
  has a same-named function in the sibling ``ref.py`` (a prefix match
  covers ``_inplace`` / donating variants);
* the extension's attributes a module reaches (``load_extension().f``,
  or ``ext.f`` with ``ext = load_extension()``) are bound in
  ``csrc/bindings.cpp``, and every ``m.def`` there is reached by some
  module of the directory (no unbound and no dead kernel; a binding's
  finding points at its ``m.def`` line and is suppressed by a
  ``// lint: allow-kernel`` comment on it or the line above);
* no ``try`` whose body calls the extension has a handler that falls
  back: one that names ``ref``, the device ``"cpu"`` or ``.cpu()``.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint import Diagnostic, ModuleInfo
from repro_torch.analysis.rules import Rule, _attr_chain

_EXEMPT = {"ref.py", "ops.py", "build.py", "__init__.py"}
_BINDINGS = Path("csrc") / "bindings.cpp"
_DEF_RE = re.compile(r'\bm\.def\(\s*"([A-Za-z0-9_]+)"')
_CPP_ALLOW_RE = re.compile(r"//\s*lint:.*\ballow-kernel\b")


def _parse(path: Path) -> Optional[ast.AST]:
    try:
        return ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return None


def _ref_names(kdir: Path) -> Optional[Set[str]]:
    tree = _parse(kdir / "ref.py") if (kdir / "ref.py").is_file() else None
    if tree is None:
        return None
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def _is_load(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _attr_chain(node.func)[-1:] == ["load_extension"]


def _ext_names(tree: ast.AST) -> Set[str]:
    """Names bound to the extension module: ``ext = load_extension()``."""
    return {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign) and _is_load(n.value)
            for t in n.targets if isinstance(t, ast.Name)}


def _reached(tree: ast.AST) -> List[Tuple[str, int]]:
    """(extension attribute, line) for every ``load_extension().f`` and
    ``ext.f`` in ``tree``."""
    names = _ext_names(tree)
    return [(n.attr, n.lineno) for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and (_is_load(n.value) or (isinstance(n.value, ast.Name) and n.value.id in names))]


def _calls_extension(node: ast.AST, names: Set[str]) -> bool:
    for n in ast.walk(node):
        if _is_load(n):
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and isinstance(n.func.value, ast.Name) and n.func.value.id in names:
            return True
    return False


def _falls_back(handler: ast.ExceptHandler) -> bool:
    for n in ast.walk(handler):
        if isinstance(n, ast.Name) and n.id == "ref":
            return True
        if isinstance(n, ast.Constant) and n.value == "cpu":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "cpu":
            return True
    return False


def _bindings(kdir: Path) -> Optional[Dict[str, Tuple[int, bool]]]:
    """``m.def`` name -> (line, suppressed) in ``kdir/csrc/bindings.cpp``
    (None: no such file)."""
    path = kdir / _BINDINGS
    if not path.is_file():
        return None
    out: Dict[str, Tuple[int, bool]] = {}
    lines = path.read_text().splitlines()
    for i, text in enumerate(lines, start=1):
        for name in _DEF_RE.findall(text):
            allowed = any(_CPP_ALLOW_RE.search(lines[j - 1]) for j in (i, i - 1) if j >= 1)
            out.setdefault(name, (i, allowed))
    return out


class KernelRule(Rule):
    name = "kernel"

    def applies(self, module: ModuleInfo) -> bool:
        return "kernels" in module.parts and module.name not in _EXEMPT

    def check_modules(self, modules: List[ModuleInfo]) -> Iterable[Diagnostic]:
        out: List[Diagnostic] = []
        dirs: Dict[Path, ModuleInfo] = {}
        for m in modules:
            if self.applies(m):
                out.extend(self.check(m))
                dirs.setdefault(Path(m.path).parent, m)
        for kdir, m in sorted(dirs.items()):
            out.extend(self._check_bindings(kdir, m))
        return out

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        if not self.applies(module):
            return []
        out: List[Diagnostic] = []

        def report(node, message):
            d = module.diag(node, self.name, message)
            if d:
                out.append(d)

        names = _ext_names(module.tree)
        entries = [fn for fn in module.tree.body if isinstance(fn, ast.FunctionDef)
                   and not fn.name.startswith("_")
                   and any(_is_load(n) for n in ast.walk(fn))]
        refs = _ref_names(Path(module.path).parent) if entries else None
        for fn in entries:
            if refs is None:
                report(fn, f"kernel entry `{fn.name}` has no sibling ref.py to hold "
                           f"its plain version")
            elif not any(fn.name == r or fn.name.startswith(r) for r in refs):
                report(fn, f"kernel entry `{fn.name}` has no plain version of its name "
                           f"in ref.py")

        bound = _bindings(Path(module.path).parent)
        if bound is not None:
            for attr, line in _reached(module.tree):
                if attr not in bound:
                    report(line, f"extension function `{attr}` is not bound by an "
                                 f"m.def in {_BINDINGS.as_posix()}")

        for node in ast.walk(module.tree):
            if isinstance(node, ast.Try) and any(_calls_extension(s, names) for s in node.body):
                for h in node.handlers:
                    if _falls_back(h):
                        report(h, "a failed extension call falls back to the plain "
                                  "version or the CPU, which hides the kernel; let it "
                                  "raise")
        return out

    def _check_bindings(self, kdir: Path, anchor: ModuleInfo) -> List[Diagnostic]:
        bound = _bindings(kdir)
        if not bound:
            return []
        reached: Set[str] = set()
        for f in sorted(kdir.glob("*.py")):
            tree = _parse(f)
            if tree is not None:
                reached.update(a for a, _ in _reached(tree))
        path = kdir / _BINDINGS
        try:
            rel = path.relative_to(anchor.root).as_posix()
        except ValueError:
            rel = path.as_posix()
        return [Diagnostic(rel, line, self.name,
                           f"m.def(\"{name}\") is reached by no wrapper under "
                           f"{kdir.name}/: a dead kernel")
                for name, (line, allowed) in sorted(bound.items(), key=lambda kv: kv[1])
                if name not in reached and not allowed]
