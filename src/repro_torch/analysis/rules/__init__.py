"""One module per lint rule; ``ALL_RULES`` is the registry
``lint.run_paths`` runs.  Every rule subclasses :class:`Rule` and reports through
``module.diag`` so ``# lint: allow-<rule>`` suppressions apply
uniformly.  Clock, obs, guarded-by and metrics are the JAX package's
rules copied; hot-path and kernel check the same invariants in PyTorch
and CUDA terms."""
from __future__ import annotations

from typing import Iterable, List

from repro_torch.analysis.lint import Diagnostic, ModuleInfo


class Rule:
    """Base class: ``name`` is the kebab-case id used in diagnostics and
    ``allow-<name>`` suppressions."""

    name: str = "?"

    def check_modules(self, modules: List[ModuleInfo],
                      ) -> Iterable[Diagnostic]:
        """Default: per-module ``check``.  Cross-module rules
        (metrics) override this."""
        out: List[Diagnostic] = []
        for m in modules:
            out.extend(self.check(m))
        return out

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        return ()


def _attr_chain(node) -> List[str]:
    """``self.pool.allocator.alloc`` -> ["self", "pool", "allocator",
    "alloc"]; empty when the expression is not a plain name/attr chain."""
    import ast

    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


from repro_torch.analysis.rules.clock import ClockRule            # noqa: E402
from repro_torch.analysis.rules.obs import ObsRule                # noqa: E402
from repro_torch.analysis.rules.guarded_by import GuardedByRule   # noqa: E402
from repro_torch.analysis.rules.hot_path import HotPathRule       # noqa: E402
from repro_torch.analysis.rules.kernel import KernelRule          # noqa: E402
from repro_torch.analysis.rules.metrics import MetricsRule        # noqa: E402

ALL_RULES = [
    ClockRule(),
    ObsRule(),
    GuardedByRule(),
    HotPathRule(),
    KernelRule(),
    MetricsRule(),
]

__all__ = ["Rule", "ALL_RULES", "ClockRule", "ObsRule", "GuardedByRule",
           "HotPathRule", "KernelRule", "MetricsRule"]
