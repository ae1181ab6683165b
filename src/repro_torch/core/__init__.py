"""Core of the port: licensing math and the flat layer-name view of a
parameter tree (the JAX package's ``repro.core`` counterparts)."""
from repro_torch.core.compression import is_dynamics_param
from repro_torch.core.licensing import (FULL_TIER, LicenseTier, apply_license,
                                        interval_mask, mask_weight)
from repro_torch.core.pytree_io import flatten_params, unflatten

__all__ = ["is_dynamics_param", "FULL_TIER", "LicenseTier", "apply_license",
           "interval_mask", "mask_weight", "flatten_params", "unflatten"]
