"""Nested parameter dicts <-> flat {layer_name: tensor} by '/'-joined paths.

Mirrors ``repro.core.pytree_io``: names and their order are the JAX
package's, which flattens dicts in **sorted-key** order — ``LicenseTier``
patterns and every per-layer loop depend on both.  Unlike the JAX
version, leaves stay tensors on their own device: a flatten never copies
weights to the host.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def flatten_params(params: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict -> ordered {path: leaf}, keys visited in sorted order."""
    if not isinstance(params, dict):
        return {prefix: params}
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(params):
        path = f"{prefix}/{key}" if prefix else str(key)
        out.update(flatten_params(params[key], path))
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat {'a/b/c': leaf} -> nested dicts, the inverse of
    :func:`flatten_params`."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
