"""Mesh construction over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  Defined as FUNCTIONS, so
importing this module touches no process group:

  make_production_mesh(multi_pod=)  (16, 16) ("data", "model"), or
                                    (2, 16, 16) ("pod", "data", "model"),
                                    over the default process group of 256
                                    or 512 ranks (a ``torchrun`` world, or
                                    :func:`fake_world` for planning on
                                    ``meta``);
  fake_world(n)                     the fake backend of ``n`` ranks: no
                                    process, no byte moved, every
                                    collective returns at once;
  make_host_mesh(device=)           a (1, 1) mesh with the same axis names
                                    over a world of one: NCCL on the card,
                                    gloo only for ``device="cpu"``.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")
MULTI_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over the default process group, which must
    exist and have exactly as many ranks as the mesh has devices.  The
    ranks' device follows the group's backend: ``cuda`` under NCCL, else
    ``cpu`` (gloo, or :func:`fake_world`, whose tensors live on ``meta``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs a process group of {n} ranks; "
                           f"none is initialized (use fake_world({n}) to plan on meta)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=MULTI_AXES if multi_pod else AXES)


def fake_world(n: int) -> None:
    """Initialize the default process group as torch's fake backend of
    ``n`` ranks, this process being rank 0: collectives are recorded
    by dispatch (``launch/op_cost.py`` counts them) and move nothing.
    The dry run calls it explicitly to plan a 256- or 512-rank mesh on
    ``meta`` tensors; it is never a fallback for a real world.

    ``FakeStore`` lives in ``torch.testing._internal``, an API internal to
    torch; torch 2.11 and 2.13 both have it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """A (1, 1) mesh with the production axis names over a world of one
    rank: NCCL on the card, gloo only when the caller asks for
    ``device="cpu"`` (the CPU tests).  The rendezvous is a ``FileStore``
    in a fresh temporary directory, so no port is opened for it.  An NCCL
    that fails raises; nothing falls back to gloo or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA card")
        backend = "nccl"
        torch.cuda.set_device(dev.index or 0)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_host_mesh: no backend for device {device!r}")
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    store = dist.FileStore(str(Path(tempfile.mkdtemp(prefix="host_mesh_")) / "store"), 1)
    kw = {"device_id": torch.device("cuda", dev.index or 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=0, world_size=1, **kw)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=AXES)
