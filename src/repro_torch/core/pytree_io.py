"""Nested parameter dicts <-> flat {layer_name: leaf} by '/'-joined paths.

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


def unflatten_like(template: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """Rebuild ``template``'s nested structure from a flat dict, checking
    that every layer is present with the template leaf's shape (the
    ``WeightStore`` boundary's guard, as in ``repro.core.pytree_io``)."""
    if isinstance(template, dict):
        return {key: unflatten_like(template[key], flat,
                                    f"{prefix}/{key}" if prefix else str(key))
                for key in template}
    if prefix not in flat:
        raise KeyError(f"missing layer {prefix!r} in store payload")
    leaf = flat[prefix]
    if tuple(leaf.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix!r}: store "
                         f"{tuple(leaf.shape)} vs template {tuple(template.shape)}")
    return leaf
