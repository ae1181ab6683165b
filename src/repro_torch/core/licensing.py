"""Dynamic licensing (paper §3.5) on torch tensors.

A *license tier* is a set of per-layer magnitude intervals; weights whose
|w| falls inside a masked interval are zeroed at serve time, so one
stored weight set serves every accuracy tier.  Mirrors
``repro.core.licensing`` (``LicenseTier`` hashes to the same
``fingerprint()``); Algorithm 1 calibration is not ported yet.

Numerics: the JAX package compares ``|w| >= lo`` with ``lo`` a weakly
typed Python float, i.e. in the weight's own dtype.  Here the bound is
cast to the weight dtype explicitly, so bf16 weights are masked against
the same bf16-rounded bounds.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.compression import is_dynamics_param
from repro_torch.core.pytree_io import flatten_params, unflatten

Interval = Tuple[float, float]


@dataclass(frozen=True)
class LicenseTier:
    """A named accuracy tier: per-layer-pattern magnitude-interval masks.

    ``masks`` maps a substring pattern (matched against the canonical layer
    path) to intervals [lo, hi); weights with lo <= |w| < hi are zeroed.
    Pattern "*" applies to every maskable layer.
    """

    name: str
    masks: Dict[str, Tuple[Interval, ...]] = field(default_factory=dict)
    accuracy: Optional[float] = None

    def intervals_for(self, layer_name: str) -> List[Interval]:
        out: List[Interval] = []
        for pattern, ivs in self.masks.items():
            if pattern == "*" or pattern in layer_name:
                out.extend(ivs)
        return out

    def as_json(self) -> Dict[str, list]:
        return {k: [list(iv) for iv in v] for k, v in self.masks.items()}

    def fingerprint(self) -> str:
        """Stable short hash of (name, masks) — identical to the JAX
        package's, so both name the same mask definition."""
        payload = json.dumps({"name": self.name, "masks": self.as_json()},
                             sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    @staticmethod
    def from_json(name: str, masks: Dict[str, Sequence[Sequence[float]]],
                  accuracy: Optional[float] = None) -> "LicenseTier":
        return LicenseTier(
            name=name,
            masks={k: tuple((float(a), float(b)) for a, b in v) for k, v in masks.items()},
            accuracy=accuracy,
        )


FULL_TIER = LicenseTier(name="full", masks={})


def interval_mask(w: torch.Tensor, intervals: Sequence[Interval]) -> torch.Tensor:
    """Boolean mask: True where the weight SURVIVES (|w| outside all intervals)."""
    if not intervals:
        return torch.ones(w.shape, dtype=torch.bool, device=w.device)
    mag = w.abs()
    dead = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    for lo, hi in intervals:
        # 0-dim CPU tensors in the weight dtype: the JAX weak-typed compare
        lo_t = torch.tensor(lo, dtype=w.dtype)
        hi_t = torch.tensor(hi, dtype=w.dtype)
        dead |= (mag >= lo_t) & (mag < hi_t)
    return ~dead


def mask_weight(w: torch.Tensor, intervals: Sequence[Interval]) -> torch.Tensor:
    return torch.where(interval_mask(w, intervals), w, torch.zeros_like(w))


def apply_license(
    params: Any,
    tier: LicenseTier,
    *,
    exclude: Callable[[str], bool] = is_dynamics_param,
) -> Any:
    """Return params with the tier's interval masks applied.

    Masked leaves are new tensors on the weights' device; every other
    leaf is shared with ``params`` by reference (the full tier returns
    ``params`` itself)."""
    if not tier.masks:
        return params
    flat = flatten_params(params)
    out = {}
    for name, arr in flat.items():
        ivs = tier.intervals_for(name)
        if not ivs or exclude(name) or arr.ndim < 2:
            out[name] = arr
        else:
            out[name] = mask_weight(arr, ivs)
    return unflatten(out)
