"""Per-op cost of a step, counted by dispatch: one rank's flops, traffic
bytes and collective bytes, each attributed to the code that issued it.

Counterpart of ``repro/launch/hlo_cost.py``.  torch has no HLO to parse,
and an eager step runs every layer (there is no while body counted
once), so the cost is counted where the ops run: :class:`OpCostMode` is
a ``TorchDispatchMode`` that sees every aten op on plain (local) tensors.
On a ``DTensor`` it steps aside (``NotImplemented``) so that DTensor
first turns the op into the rank's local ops and the collectives it
inserts, which the mode then counts: what it sums is one rank's share.
Under ``FlopCounterMode`` as well (the dry run's global flops), enter
this mode first, so that the flop counter sees the DTensor ops.

  flops             ``torch.utils.flop_counter``'s registry (matmuls,
                    convolutions, attention), per op on its local shapes;
  traffic bytes     the bytes of every tensor input read plus every
                    tensor output written, ``hlo_cost``'s rule; view ops
                    move nothing and are not counted;
  collective bytes  the output bytes of each ``_c10d_functional`` op, by
                    kind (``roofline.CollectiveStats``).

Each op is keyed by the innermost ``repro_torch`` frame that issued it,
``path/in/package.py:function`` (the counterpart of HLO ``op_name``
provenance), a product through ``models.layers.matmul`` by that
function's caller; ops issued from outside the package are keyed
``<outside>``.
"""
from __future__ import annotations

import os
import sys
from collections import Counter
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import CollectiveStats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # .../repro_torch
_HERE = os.path.abspath(__file__)
_C10D = "_c10d_functional"
# the namespace's collectives (its other ops, wait_tensor and the autograd
# wrapper, move nothing)
_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast")

# allocations that read and write no element
_UNTOUCHED = (torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
              torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


# helpers that issue an op on their caller's behalf: the op is the caller's
_FORWARDERS = frozenset({"models/layers.py:matmul"})


def _site() -> str:
    """``file:function`` of the innermost frame in the package (this
    module's own frames and the ``_FORWARDERS`` skipped)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path != _HERE:
            site = f"{os.path.relpath(path, _PKG)}:{f.f_code.co_name}"
            if site not in _FORWARDERS:
                return site
        f = f.f_back
    return "<outside>"


class OpCostMode(TorchDispatchMode):
    """Counts one rank's cost of the ops run under it (see the module
    docstring): totals in ``flops``, ``traffic_bytes`` and
    ``collectives``, and the same by issuing site in ``flops_by_site``,
    ``traffic_by_site`` and ``collective_by_site`` (Counters)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic_bytes = 0
        self.collectives = CollectiveStats()
        self.flops_by_site: Counter = Counter()
        self.traffic_by_site: Counter = Counter()
        self.collective_by_site: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor lower it to local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # views and allocations move nothing (DTensor's planner splits
        # tensors into many views); DTensor derives an op's global shapes
        # by running it once on fake tensors: not the rank's work
        if (not isinstance(func, torch._ops.OpOverload) or func.is_view
                or func.overloadpacket in _UNTOUCHED
                or any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(t, FakeTensor) for t in tree_flatten(out)[0])):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if func.namespace == _C10D:
            name = packet.__name__
            if name.startswith(_COLLECTIVES):
                nbytes = _bytes(out)
                self.collectives.add(name, nbytes)
                self.collective_by_site[_site()] += nbytes
            return
        site: Optional[str] = None
        flop_fn = flop_registry.get(packet)
        if flop_fn is not None:
            n = flop_fn(*args, **kwargs, out_val=out)
            if n:
                site = _site()
                self.flops += n
                self.flops_by_site[site] += n
        nbytes = _bytes((args, kwargs)) + _bytes(out)
        if nbytes:
            self.traffic_bytes += nbytes
            self.traffic_by_site[site or _site()] += nbytes
