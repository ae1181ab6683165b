"""The part of ``repro.core.compression`` the licensing path needs: which
parameters are exempt from masking.  The rest of the compression
pipeline (prune, int8, weight sharing) is not ported yet (ROADMAP,
"offline tooling")."""
from __future__ import annotations

# Parameters whose magnitude encodes recurrence *dynamics* rather than a
# linear map; every licensing entry point excludes them.
DYNAMICS_PARAM_KEYWORDS = ("A_log", "dt_bias", "a_param", "norm", "scale", "bias_embed")


def is_dynamics_param(name: str) -> bool:
    return any(k in name for k in DYNAMICS_PARAM_KEYWORDS)
