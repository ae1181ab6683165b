"""Dynamic and static licensing (paper §3.5, Algorithm 1) on torch tensors.

A *license tier* is a set of per-layer magnitude intervals; weights whose
|w| falls inside a masked interval are zeroed at serve time, so one
stored weight set serves every accuracy tier.  Mirrors
``repro.core.licensing`` (``LicenseTier`` hashes to the same
``fingerprint()``):

* ``apply_license`` — the mask transform;
* ``calibrate_license`` — Algorithm 1: divide the weight range into k
  intervals, cumulatively cut intervals layer by layer until the
  evaluated accuracy reaches the target;
* ``make_static_tiers`` — a ladder of tiers for the Accuracy table;
* ``license_stats`` — the fraction of weights a tier hides.

Numerics: the JAX package compares ``|w| >= lo`` with ``lo`` a weakly
typed Python float, i.e. in the weight's own dtype.  Here the bound is
cast to the weight dtype explicitly, so bf16 weights are masked against
the same bf16-rounded bounds; Algorithm 1 cuts through the same
``mask_weight``.  Its quantile edges are ``np.quantile``'s over every
maskable magnitude (:func:`magnitude_quantiles`), computed without
concatenating the model.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
    """``w`` with the weights inside ``intervals`` zeroed.  A stacked
    leaf (ndim >= 3) is masked one slice of its leading (unit) axis at a
    time into one output: the function is elementwise, so the result is
    the same, and the masks in flight stay one unit's size (a (32, 6144,
    24576) bf16 leaf would otherwise hold ~20 GB of them beside itself)."""
    if w.ndim >= 3:
        out = torch.empty_like(w)
        for i in range(w.shape[0]):
            out[i] = mask_weight(w[i], intervals)
        return out
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


def license_stats(params: Any, tier: LicenseTier,
                  exclude: Callable[[str], bool] = is_dynamics_param) -> Dict[str, float]:
    """Fraction of weights hidden by the tier (reported per benchmark run)."""
    flat = flatten_params(params)
    total = masked = 0
    for name, arr in flat.items():
        ivs = tier.intervals_for(name)
        total += arr.numel()
        if ivs and not exclude(name) and arr.ndim >= 2:
            masked += arr.numel() - int(interval_mask(arr, ivs).sum())
    return {"total": float(total), "masked": float(masked),
            "masked_frac": masked / max(total, 1)}


# ------------------------------------------------------ the quantile edges
_COUNT_CHUNK = 1 << 26       # elements per bincount: bounds its int32 copy


def _order_stats_16bit(leaves: Sequence[torch.Tensor], ks: np.ndarray) -> List[float]:
    """The ``ks``-th smallest |w| over every leaf, for a 16-bit float
    dtype: the non-negative values of bf16 and f16 order as their bit
    patterns do, so one count of the 2^15 magnitude patterns, leaf by
    leaf on the leaves' device, gives every order statistic exactly, with
    no sort and no concatenation."""
    dtype = leaves[0].dtype
    counts = torch.zeros(1 << 15, dtype=torch.int64, device=leaves[0].device)
    for leaf in leaves:
        for part in leaf.detach().reshape(-1).split(_COUNT_CHUNK):
            bits = part.view(torch.int16).to(torch.int32) & 0x7FFF
            counts += torch.bincount(bits, minlength=1 << 15).to(counts.device)
    cdf = counts.cumsum(0).cpu().numpy()
    pats = np.searchsorted(cdf, ks, side="right").astype(np.int16)
    return torch.from_numpy(pats).view(dtype).tolist()


def _order_stats_sorted(leaves: Sequence[torch.Tensor], ks: np.ndarray) -> List[float]:
    """The ``ks``-th smallest |w| by one sort of every magnitude (wider
    dtypes; the smoke-size models)."""
    mags = torch.cat([leaf.detach().abs().reshape(-1) for leaf in leaves])
    return mags.sort().values[torch.from_numpy(ks)].tolist()


def magnitude_quantiles(leaves: Sequence[torch.Tensor], qs: np.ndarray) -> np.ndarray:
    """``np.quantile(np.concatenate([|w| of each leaf]), qs)`` (method
    "linear"), bit for bit, as a float64 array.

    The order statistics come from a count of bit patterns for 16-bit
    weights and from a sort otherwise; then numpy's interpolation is
    replayed in its own arithmetic: virtual index ``(n - 1) * q``, the
    neighbours' difference rounded to the weights' dtype, and the
    two-sided lerp (``a + d*t``, or ``b - d*(1 - t)`` for ``t >= 0.5``)
    in float64."""
    dtype = leaves[0].dtype
    if any(leaf.dtype != dtype for leaf in leaves):
        raise TypeError("magnitude_quantiles needs leaves of one dtype, got "
                        f"{sorted({str(leaf.dtype) for leaf in leaves})}")
    n = sum(leaf.numel() for leaf in leaves)
    virtual = (n - 1) * np.asarray(qs, np.float64)
    prev = np.floor(virtual)
    gamma = virtual - prev
    prev = prev.astype(np.int64)
    nxt = prev + 1
    top = virtual >= n - 1                 # numpy takes the maximum there
    prev[top] = nxt[top] = n - 1
    ks = np.concatenate([prev, nxt])
    stats = (_order_stats_16bit if leaves[0].element_size() == 2
             and dtype.is_floating_point else _order_stats_sorted)(leaves, ks)
    a, b = stats[: len(prev)], stats[len(prev):]
    out = np.empty(len(prev), np.float64)
    for i, (lo, hi, t) in enumerate(zip(a, b, gamma)):
        # np.subtract of two weights rounds to their dtype
        d = (torch.tensor(hi, dtype=dtype) - torch.tensor(lo, dtype=dtype)).item()
        out[i] = hi - d * (1 - t) if t >= 0.5 else lo + d * t
    return out


# ----------------------------------------------------------- Algorithm 1
@dataclass
class CalibrationStep:
    interval: Interval
    layer: str
    accuracy: float


def calibrate_license(
    params: Any,
    eval_fn: Callable[[Any], float],
    target_accuracy: float,
    *,
    k_intervals: int = 10,
    tier_name: str = "custom",
    tolerance: float = 0.02,
    layer_order: Optional[List[str]] = None,
    exclude: Callable[[str], bool] = is_dynamics_param,
    interval_mode: str = "quantile",
    refine_steps: int = 0,
) -> Tuple[LicenseTier, List[CalibrationStep]]:
    """Algorithm 1 — prune the model based on desired accuracy.

    Divide the weight range into k intervals; for each interval, for
    each layer, cut the weights in that interval; stop when the accuracy
    of the pruned model is within ``tolerance`` of the target.  Returns
    the tier holding the CUT intervals per layer, and the step trace.

    ``interval_mode``: "quantile" (default) makes intervals equal in
    POPULATION (:func:`magnitude_quantiles` over every maskable weight);
    "width" is the literal equal-width reading.  ``refine_steps`` > 0
    bisects the last interval's upper edge that many times, landing the
    accuracy closer to the target.  ``eval_fn`` gets the nested parameter
    dict with the cuts so far applied.
    """
    flat = flatten_params(params)
    maskable = [n for n, a in flat.items() if not exclude(n) and a.ndim >= 2]
    if layer_order is not None:
        maskable = [n for n in layer_order if n in maskable]

    hi = max(float(flat[n].detach().abs().max()) for n in maskable)
    if interval_mode == "quantile":
        qs = np.linspace(0.0, 1.0, k_intervals + 1)
        edges = magnitude_quantiles([flat[n] for n in maskable], qs)
        edges[0], edges[-1] = 0.0, hi * (1 + 1e-6)
        edges = np.maximum.accumulate(edges)
    else:
        edges = np.linspace(0.0, hi * (1 + 1e-6), k_intervals + 1)

    cut: Dict[str, List[Interval]] = {n: [] for n in maskable}
    trace: List[CalibrationStep] = []
    current = dict(flat)

    # ascending magnitude: cut the least important (smallest) intervals
    # first, as gradual magnitude pruning does (§3.5)
    done = False
    last_layer = None
    for i in range(k_intervals):
        iv = (float(edges[i]), float(edges[i + 1]))
        for layer in maskable:
            cut[layer].append(iv)
            current[layer] = mask_weight(current[layer], [iv])
            acc = float(eval_fn(unflatten(current)))
            trace.append(CalibrationStep(interval=iv, layer=layer, accuracy=acc))
            if acc <= target_accuracy + tolerance:
                done = True
                last_layer = layer
                break
        if done:
            break

    if done and refine_steps and trace and last_layer is not None:
        # bisect the final interval's upper edge on its layer
        lo_edge, hi_edge = cut[last_layer][-1]
        base = dict(current)
        base[last_layer] = flat[last_layer]
        # replay every cut on this layer except the final one
        for iv in cut[last_layer][:-1]:
            base[last_layer] = mask_weight(base[last_layer], [iv])
        best_hi, lo, hi = hi_edge, lo_edge, hi_edge
        for _ in range(refine_steps):
            mid = 0.5 * (lo + hi)
            cand = dict(base)
            cand[last_layer] = mask_weight(base[last_layer], [(lo_edge, mid)])
            acc = float(eval_fn(unflatten(cand)))
            trace.append(CalibrationStep(interval=(lo_edge, mid),
                                         layer=last_layer, accuracy=acc))
            if acc <= target_accuracy:
                best_hi, hi = mid, mid   # overshoot: shrink the cut
            else:
                lo = mid                 # undershoot: widen toward hi_edge
                best_hi = hi
        cut[last_layer][-1] = (lo_edge, float(best_hi))

    tier = LicenseTier(name=tier_name,
                       masks={n: tuple(v) for n, v in cut.items() if v})
    if trace:
        # re-evaluate the final tier exactly
        final = apply_license(params, tier, exclude=exclude)
        tier = LicenseTier(name=tier.name, masks=tier.masks,
                           accuracy=float(eval_fn(final)))
    return tier, trace


def make_static_tiers(
    params: Any,
    eval_fn: Callable[[Any], float],
    tier_targets: Dict[str, float],
    *,
    k_intervals: int = 10,
) -> Dict[str, LicenseTier]:
    """Precompute the Accuracy-table ladder (static licensing, §3.5)."""
    tiers: Dict[str, LicenseTier] = {}
    for name, target in sorted(tier_targets.items(), key=lambda kv: -kv[1]):
        tiers[name], _ = calibrate_license(params, eval_fn, target,
                                           k_intervals=k_intervals, tier_name=name)
    return tiers
