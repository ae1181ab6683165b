"""Static and runtime checks of the port's serving invariants, after the
JAX package's ``repro/analysis``:

* :mod:`repro_torch.analysis.lint` and :mod:`repro_torch.analysis.rules`
  — the AST lint pass (``python -m repro_torch.analysis.lint``, default
  path ``src/repro_torch``): the JAX package's clock, obs, guarded-by and
  metrics rules copied, hot-path and kernel in PyTorch and CUDA terms;
* :mod:`repro_torch.analysis.metrics` — the ``metrics()`` schema
  set-difference primitives behind ``validate_gateway_metrics``;
* :mod:`repro_torch.analysis.sanitize` — opt-in runtime sanitizers
  (``LicensedGateway(..., sanitize=True)`` or ``REPRO_SANITIZE=1``): a
  shadow model of the block allocator and a step-shape sentinel;
* :mod:`repro_torch.analysis.lockstep` — a seeded deterministic
  scheduler serializing the staged-sync fetch worker against the serving
  thread at annotated yield points, asserting ``guarded-by`` field
  ownership.

This module imports nothing at package-import time: serving modules
import :mod:`repro_torch.analysis.lockstep`, and a package-level import
would create a cycle back into ``repro_torch.serving``; the lint imports
neither ``torch`` nor the serving modules.
"""
from __future__ import annotations

__all__ = ["lint", "lockstep", "metrics", "rules", "sanitize"]
