"""Project-specific AST lint pass over the port's tree.

Usage::

    python -m repro_torch.analysis.lint                     # src/repro_torch
    python -m repro_torch.analysis.lint src/repro_torch/serving/gateway.py
    python -m repro_torch.analysis.lint src/repro_torch --rule hot-path

Copied from the JAX package's ``repro/analysis/lint.py``.  Each rule lives
in its own module under :mod:`repro_torch.analysis.rules` and checks one
serving invariant: clock, obs, guarded-by and metrics as in the JAX
package (``docs/ANALYSIS.md`` is their catalog), hot-path and kernel in
PyTorch and CUDA terms (host syncs of tensors in the step loops; every
kernel wrapper paired with its plain version and its binding, and no
fallback around an extension call).  Diagnostics carry ``path:line`` so
editors and CI can jump to the site.  A finding is suppressed by putting
``# lint: allow-<rule>`` on the flagged line or the line directly above
it — e.g.::

    t0 = time.monotonic()   # lint: allow-clock

Exit status is 0 when the tree is clean, 1 when any diagnostic fired,
2 on usage errors.  Nothing here imports ``torch`` or ``jax``.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = [
    "Diagnostic", "ModuleInfo", "load_module", "collect_modules",
    "run_paths", "render", "main",
]

DEFAULT_PATH = Path(__file__).resolve().parents[1]      # src/repro_torch

_ALLOW_RE = re.compile(r"#\s*lint:\s*((?:allow-[A-Za-z0-9_-]+[,\s]*)+)")
_ALLOW_TOKEN_RE = re.compile(r"allow-([A-Za-z0-9_-]+)")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``path:line: RULE-NAME: message``."""

    path: str
    line: int
    rule: str            # short kebab-case rule id, e.g. "clock"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: RULE-{self.rule.upper()}: " \
               f"{self.message}"


@dataclass
class ModuleInfo:
    """A parsed source file plus the bits every rule needs: the AST with
    parent links, raw lines, and the per-line suppression sets."""

    path: Path
    root: Path                      # scan root the path was found under
    tree: ast.AST
    lines: List[str]
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    @property
    def rel(self) -> str:
        try:
            return self.path.relative_to(self.root).as_posix()
        except ValueError:
            return self.path.as_posix()

    @property
    def name(self) -> str:
        return self.path.name

    @property
    def parts(self) -> Sequence[str]:
        return Path(self.rel).parts

    def suppressed(self, line: int, rule: str) -> bool:
        """A diagnostic at ``line`` is suppressed by an allow comment on
        that line or the line directly above."""
        for ln in (line, line - 1):
            if rule in self.suppressions.get(ln, ()):
                return True
        return False

    def diag(self, node_or_line, rule: str, message: str,
             ) -> Optional[Diagnostic]:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 1))
        if self.suppressed(line, rule):
            return None
        return Diagnostic(self.rel, line, rule, message)


def _parse_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = set(_ALLOW_TOKEN_RE.findall(m.group(1)))
    return out


def _link_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._lint_parent = parent  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def load_module(path: Path, root: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError) as exc:
        print(f"lint: skipping {path}: {exc}", file=sys.stderr)
        return None
    _link_parents(tree)
    lines = source.splitlines()
    return ModuleInfo(path=path, root=root, tree=tree, lines=lines,
                      suppressions=_parse_suppressions(lines))


def collect_modules(paths: Sequence[Path]) -> List[ModuleInfo]:
    mods: List[ModuleInfo] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                m = load_module(f, p)
                if m is not None:
                    mods.append(m)
        elif p.suffix == ".py":
            # anchor at the fs root so path-scoped rules ("serving" in
            # parts) still see the directory when given a lone file
            p = p.resolve()
            m = load_module(p, Path(p.anchor))
            if m is not None:
                mods.append(m)
        else:
            raise FileNotFoundError(f"not a python file or directory: {p}")
    return mods


def run_paths(paths: Sequence[Path], rules=None) -> List[Diagnostic]:
    """Lint ``paths`` (files or trees) and return all diagnostics."""
    from repro_torch.analysis.rules import ALL_RULES

    rules = list(ALL_RULES if rules is None else rules)
    modules = collect_modules([Path(p) for p in paths])
    diags: List[Diagnostic] = []
    for rule in rules:
        diags.extend(rule.check_modules(modules))
    return sorted(diags, key=lambda d: (d.path, d.line, d.rule))


def render(diags: Sequence[Diagnostic]) -> str:
    return "\n".join(d.render() for d in diags)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's serving-invariant lint pass (see docs/ANALYSIS.md "
                    "and repro_torch.analysis.rules)")
    parser.add_argument("paths", nargs="*", default=[str(DEFAULT_PATH)],
                        help="files or directory trees to lint (default: the "
                             "repro_torch package)")
    parser.add_argument("--rule", action="append", default=None,
                        help="run only this rule id (repeatable), "
                             "e.g. --rule clock")
    args = parser.parse_args(argv)
    from repro_torch.analysis.rules import ALL_RULES

    rules = ALL_RULES
    if args.rule:
        wanted = set(args.rule)
        rules = [r for r in ALL_RULES if r.name in wanted]
        unknown = wanted - {r.name for r in rules}
        if unknown:
            parser.error(f"unknown rule(s): {sorted(unknown)} "
                         f"(known: {[r.name for r in ALL_RULES]})")
    try:
        diags = run_paths(args.paths, rules)
    except FileNotFoundError as exc:
        parser.error(str(exc))
    if diags:
        print(render(diags))
        print(f"lint: {len(diags)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
