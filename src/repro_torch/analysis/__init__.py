"""Runtime checks of the port's serving invariants, copied from the JAX
package's ``repro/analysis``:

* :mod:`repro_torch.analysis.metrics` — the ``metrics()`` schema
  set-difference primitives behind ``validate_gateway_metrics``;
* :mod:`repro_torch.analysis.sanitize` — opt-in runtime sanitizers
  (``LicensedGateway(..., sanitize=True)`` or ``REPRO_SANITIZE=1``): a
  shadow model of the block allocator and a step-shape sentinel;
* :mod:`repro_torch.analysis.lockstep` — a seeded deterministic
  scheduler serializing the staged-sync fetch worker against the serving
  thread at annotated yield points, asserting ``guarded-by`` field
  ownership.

The static lint (``repro.analysis.lint``) is not copied: it is a
development tool over source files, and it already lints this package.
This module imports nothing at package-import time: serving modules
import :mod:`repro_torch.analysis.lockstep`, and a package-level import
would create a cycle back into ``repro_torch.serving``.
"""
from __future__ import annotations

__all__ = ["lockstep", "metrics", "sanitize"]
