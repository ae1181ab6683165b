"""Roofline terms of a step on one card.

Counterpart of ``repro/launch/roofline.py`` with the card's published
peaks in place of the TPU v5e's: the least time a step can take on one
card is the larger of

    compute = flops / peak FLOP/s of the step's dtype    [s]
    memory  = bytes / HBM bytes/s                         [s]

The flops are the dry run's, counted by ``FlopCounterMode`` on the real
step (``launch/dryrun.py``), where the JAX package parses compiled HLO.
The bytes are a lower bound: every weight and cache tensor the step
reads, once, plus the cache it writes (:func:`step_bytes`); activations,
and a recurrent state a decode step rewrites, are not counted.

On a mesh of ``chips`` ranks (``dryrun --mesh``) the terms are one
rank's, as in the JAX report:

    compute    = flops / chips / peak FLOP/s             [s]
    memory     = the rank's bytes / HBM bytes/s          [s]
    collective = the rank's collective bytes / link B/s  [s]

with the flops still the step's global count and the collective bytes
the output bytes of every collective the rank issues
(:class:`CollectiveStats`, counted by ``launch/op_cost.py``).  One card
has no collectives: off the mesh the report has no collective term.

``CARD_PEAKS`` are the only copy of the peaks: ``chip_smoke.py`` bounds
its kernels with them.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

# published peaks (NVIDIA data sheets, SXM parts): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (the rate the kernels' f32 arithmetic runs at),
# and the dense bf16 tensor-core FLOP/s (bounds work on bf16 inputs)
CARD_PEAKS = {"H100": (3.35e12, 67e12, 989e12), "H200": (4.8e12, 67e12, 989e12)}
RATE_NAMES = {1: "f32 67e12 FLOP/s", 2: "bf16 tensor cores 989e12 FLOP/s"}
# one card's NVLink bytes/s each way (NVIDIA H100 and H200 SXM data sheets:
# NVLink 4, 900 GB/s both ways); the rate between hosts of a 32-node mesh
# is not modelled
CARD_LINKS = {"H100": 450e9, "H200": 450e9}


def card_key(name: str):
    """The ``CARD_PEAKS`` key of a device name (``torch.cuda.get_device_name``),
    or None when no published peaks match it."""
    return next((k for k in CARD_PEAKS if k in name), None)


def present_card():
    """(``CARD_PEAKS`` key, memory bytes, where they were read): the card
    present, picked by its device name, with its own memory; an H100
    80GB when no card is present.  The one choice of card behind a
    report's peaks and its memory limit."""
    import torch

    if not torch.cuda.is_available():
        return "H100", 80 * 2**30, "80 GiB (H100 80GB; no card present)"
    name = torch.cuda.get_device_name(0)
    key = card_key(name)
    if key is None:
        raise ValueError(f"no published peaks for {name!r}")
    return key, torch.cuda.get_device_properties(0).total_memory, name


@dataclass
class CollectiveStats:
    """Output bytes and counts of the collectives one rank issued, by
    kind (the ``_c10d_functional`` op's name: ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``, ...)."""
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    card: str
    flops: float                  # counted on the step
    bytes: float                  # lower bound (step_bytes)
    compute_s: float
    memory_s: float
    dominant: str
    model_flops: float            # 6·N(_active)·D train, 2·N·D otherwise
    useful_flops_ratio: float     # model_flops / flops
    note: str = ""
    # on a mesh only (None off it, and left out of as_dict)
    chips: Optional[int] = None
    collective_bytes: Optional[float] = None   # one rank's
    collective_s: Optional[float] = None

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s or 0.0)

    def as_dict(self):
        out = asdict(self)
        if self.chips is None:
            for k in ("chips", "collective_bytes", "collective_s"):
                del out[k]
        return out


def step_bytes(kind: str, weight_bytes: float, cache_bytes: float,
               write_bytes: float) -> float:
    """The HBM bytes a step must move, at least: ``train`` reads the
    weights and writes their gradients; ``prefill`` reads the weights and
    writes the cache; ``decode`` reads the weights and the cache and
    writes ``write_bytes`` (one position of every per-token cache leaf)."""
    if kind == "train":
        return 2.0 * weight_bytes
    if kind == "prefill":
        return weight_bytes + cache_bytes
    return weight_bytes + cache_bytes + write_bytes


def build_report(*, arch: str, shape: str, cfg, flops: float, bytes_: float,
                 model_flops: float, card: str, note: str = "",
                 chips: Optional[int] = None,
                 collectives: Optional[CollectiveStats] = None) -> RooflineReport:
    """The roofline terms of one step on ``card`` (a ``CARD_PEAKS`` key,
    :func:`present_card`'s); a bf16 model's flops run at the tensor
    cores' rate, any other at the f32 rate.  On a mesh, ``chips`` ranks
    share the (global) ``flops``, ``bytes_`` are one rank's and
    ``collectives`` the collectives one rank issued; ``dominant`` is the
    largest of the three terms."""
    hbm, f32, bf16 = CARD_PEAKS[card]
    compute_s = flops / (chips or 1) / (bf16 if cfg.dtype_name == "bfloat16" else f32)
    memory_s = bytes_ / hbm
    terms = {"compute": compute_s, "memory": memory_s}
    coll_bytes = coll_s = None
    if chips is not None:
        coll_bytes = float((collectives or CollectiveStats()).total_bytes)
        coll_s = coll_bytes / CARD_LINKS[card]
        terms["collective"] = coll_s
    return RooflineReport(
        arch=arch, shape=shape, card=card, flops=float(flops), bytes=float(bytes_),
        compute_s=compute_s, memory_s=memory_s, dominant=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_ratio=model_flops / flops if flops else 0.0, note=note,
        chips=chips, collective_bytes=coll_bytes, collective_s=coll_s)


def model_step_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for train (fwd+bwd), 2·N·D per generated/scored
    token otherwise; N = active params."""
    counts = cfg.param_counts()
    n = counts["active"]
    if shape.kind == "train":
        tokens = shape.batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.batch  # decode: one token per sequence
