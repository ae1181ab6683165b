"""Quantized licensed serving: ONE int8 weight store, a licensed view per tier.

Counterpart of ``repro/serving/quantized.py``.  Block weights are kept
as (codes int8, scale f32) with per-output-channel scales; a tier's view
is either built by the fused masked-dequant (``kernels/masked_dequant.py``,
one CUDA launch per stacked leaf on the card) once per (tier, version)
and cached by the gateway (``materialize_int8_views=True``), or — the
default, as in the JAX package — the store itself plus the tier's packed
intervals, each unit's codes dequantized with the intervals fused inside
every forward step (``dequant_tree``, called by ``models.model.forward``:
one launch per int8 leaf of a unit on the card).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.licensing import LicenseTier
from repro_torch.kernels.ops import MAX_INTERVALS, pack_intervals

# leaves excluded from quantization (precision- or structure-critical)
_SKIP = ("norm", "bias", "router", "conv", "A_log", "dt_bias", "D_skip",
         "a_param", "tok", "lm_head", "scale")


def _eligible(name: str, leaf) -> bool:
    short = name.split("/")[-1]
    if any(k in short for k in _SKIP):
        return False
    if not hasattr(leaf, "ndim"):
        return False
    # unit-stacked weights are (U, in, out); plain 2-D under units are
    # stacked biases — leave those alone
    if "units/" in name:
        return leaf.ndim >= 3
    return "tail/" in name and leaf.ndim >= 2


def _quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8: the scale reduces over the
    second-to-last (contraction) dim.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the codes match the JAX package's.
    A unit-stacked leaf is quantized one unit at a time into
    preallocated codes and scales: each unit's scale is its own slice's,
    and the f32 copy is one unit's, not the whole leaf's (19.3 GB for
    nemotron-4-15b's ``w_up``)."""
    if w.ndim > 2:
        codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32,
                            device=w.device)
        for u in range(w.shape[0]):
            q = _quantize_leaf(w[u])
            codes[u], scale[u] = q["codes"], q["scale"]
        return {"codes": codes, "scale": scale}
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale}


def quantize_serving_params(params: Any, prefix: str = "") -> Any:
    """Same-structure tree; eligible weights become {"codes","scale"} dicts."""
    if isinstance(params, dict):
        return {k: quantize_serving_params(v, f"{prefix}/{k}" if prefix else k)
                for k, v in params.items()}
    return _quantize_leaf(params) if _eligible(prefix, params) else params


def is_qleaf(leaf) -> bool:
    return isinstance(leaf, dict) and "codes" in leaf and "scale" in leaf


def requantize_layers(qparams: Any, new_flat: Dict[str, Any],
                      touched: Sequence[str]) -> Any:
    """Incremental requantize: the int8 store with ONLY ``touched`` layers
    re-derived from ``new_flat`` (flat name -> new float tensor); every
    other leaf is shared with ``qparams``.  Whether a layer is quantized
    follows the existing store (same names and shapes across versions),
    so the result equals ``quantize_serving_params`` of the whole new
    tree bit for bit — the staged update's bounded requant step."""
    want = set(touched)

    def walk(leaf: Any, name: str) -> Any:
        if name in want:
            new = new_flat[name]
            return _quantize_leaf(new) if is_qleaf(leaf) else new
        if isinstance(leaf, dict) and not is_qleaf(leaf):
            return {k: walk(v, f"{name}/{k}" if name else k) for k, v in leaf.items()}
        return leaf

    return walk(qparams, "")


def dequant_leaf(leaf: Any, lo: torch.Tensor, hi: torch.Tensor, dtype) -> Any:
    """Fused dequant + license-interval mask of one int8 leaf (a unit's
    slice inside the forward step): ``codes * scale`` in f32, zeroed where
    ``lo[i] <= |w| < hi[i]``, cast to ``dtype``.  One
    ``kernels.masked_dequant`` call: the kernel on the card, its plain
    version on the CPU.  Anything else passes through."""
    if not is_qleaf(leaf):
        return leaf
    from repro_torch.kernels.masked_dequant import masked_dequant

    if isinstance(leaf["codes"], DTensor):
        return _dequant_sharded(leaf["codes"], leaf["scale"], lo, hi, dtype)
    return masked_dequant(leaf["codes"], leaf["scale"], lo, hi, out_dtype=dtype)


def _dequant_sharded(codes: DTensor, scale: DTensor, lo: torch.Tensor, hi: torch.Tensor,
                     dtype) -> DTensor:
    """:func:`dequant_leaf` of a leaf on a mesh: each rank dequantizes
    its own shard of the codes through ``local_map`` (the kernel on the
    card, the plain version on the CPU) and the result keeps the codes'
    placements.  The replicated scale is first cut to the rank's shard
    where it spans the sharded dim (a column-parallel leaf's per-column
    scale); a dim where the scale has size 1 (a row-parallel leaf's
    contraction dim) keeps it whole.  ``lo``/``hi`` are plain tensors,
    the same on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.masked_dequant import masked_dequant

    mesh, pls = codes.device_mesh, codes.placements
    s_pls = tuple(p if isinstance(p, Shard) and scale.shape[p.dim] == codes.shape[p.dim]
                  else Replicate() for p in pls)
    scale = scale.redistribute(mesh, s_pls)     # Replicate -> Shard: a local slice
    fn = local_map(functools.partial(masked_dequant, out_dtype=dtype), out_placements=(pls,),
                   in_placements=(pls, s_pls, None, None), device_mesh=mesh)
    return fn(codes, scale, lo, hi)


@functools.lru_cache(maxsize=None)
def _no_intervals(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inert (lo, hi) for a tier that masks nothing, made once a device."""
    z = torch.zeros(MAX_INTERVALS, dtype=torch.float32, device=device)
    return z, z


def dequant_tree(tree: Any, license_intervals, dtype) -> Any:
    """Every int8 leaf of ``tree`` through :func:`dequant_leaf`.
    ``license_intervals`` is a tier's (lo, hi) on the leaves' device
    (:func:`tier_intervals`); ``None`` masks nothing.  On the CPU the
    plain version is given the live slots (lo < hi) only: it loops over
    the slots it gets, and the in-scan path runs it on every leaf of
    every step."""
    first = next(qleaves(tree), None)
    if first is None:
        return tree
    device = first["codes"].device
    lo, hi = _no_intervals(device) if license_intervals is None else license_intervals
    if isinstance(lo, DTensor) or isinstance(hi, DTensor):
        raise TypeError("dequant_tree: the tier's lo/hi are plain tensors, the same on "
                        "every rank of a mesh")
    if device.type == "cpu":
        live = lo < hi
        lo, hi = lo[live], hi[live]
    return _map_qleaves(lambda leaf: dequant_leaf(leaf, lo, hi, dtype), tree)


def qleaves(tree: Any):
    """The int8 leaves of ``tree``, in order."""
    if is_qleaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from qleaves(v)


def _map_qleaves(fn, tree: Any) -> Any:
    if is_qleaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_qleaves(fn, v) for k, v in tree.items()}
    return tree


def materialize_licensed_view(qparams: Any, tier: Optional[LicenseTier],
                              dtype) -> Any:
    """Run the fused masked-dequant once, returning a full-precision
    licensed view of the int8 store (the gateway's
    ``materialize_int8_views`` path).  The tier's intervals are packed
    once per view, on the store's device; each quantized leaf, 2-D or
    stacked (U, in, out), is one ``kernels.masked_dequant`` call on its
    (units, in, out) form (one launch on the card), written straight
    into its view tensor.  The JAX
    package dequantizes stacked leaves slice by slice and stacks them:
    the function is elementwise, so the results are identical.
    Non-quantized leaves are shared with the store."""
    from repro_torch.kernels.masked_dequant import masked_dequant

    device = qparams["embed"]["tok"].device
    li = tier_intervals(tier, device=device)
    ivs = [] if li is None else [(a, b) for a, b in zip(*(t.tolist() for t in li)) if b > a]
    lo, hi = pack_intervals(ivs, device=device)

    def dq(leaf):
        codes, scale = leaf["codes"], leaf["scale"]
        out = masked_dequant(codes.reshape(-1, *codes.shape[-2:]),
                             scale.reshape(-1, *scale.shape[-2:]), lo, hi, out_dtype=dtype)
        return out.reshape(codes.shape)

    return _map_qleaves(dq, qparams)


def tier_intervals(tier: Optional[LicenseTier], *, device,
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Pack a tier's intervals for the fused dequant, on ``device`` (no
    default: the caller names it), copied as the JAX package has it: the
    '*' intervals first, then every other pattern's, merged into ONE
    global set (so on a tier with per-layer patterns the int8 view masks
    more than ``apply_license`` does).  ``None`` for a tier that masks nothing.  One host-to-device
    copy: the in-scan view packs once per (tier, version), never in a
    step."""
    if tier is None or not tier.masks:
        return None
    ivs = list(tier.masks.get("*", ()))
    for pat, v in tier.masks.items():
        if pat != "*":
            ivs.extend(v)
    if not ivs:
        return None
    return pack_intervals(ivs, device=device)
