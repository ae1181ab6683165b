"""Multi-device placement: DTensor placements for params/opt/cache/data."""
from repro_torch.distribution.sharding import (
    MeshShape,
    batch_spec,
    cache_shardings,
    data_shardings,
    distribute_tree,
    dp_axes,
    local_bytes,
    opt_state_shardings,
    param_spec,
    params_shardings,
    replicated,
    spec_of,
)

__all__ = [
    "MeshShape", "batch_spec", "cache_shardings", "data_shardings", "distribute_tree",
    "dp_axes", "local_bytes", "opt_state_shardings", "param_spec", "params_shardings",
    "replicated", "spec_of",
]
