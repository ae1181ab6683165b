"""Partition rules as DTensor placements: params, optimizer state, caches
and inputs per architecture.

Counterpart of ``repro/distribution/sharding.py``, rule for rule:

  * batch over ("pod", "data") -- pure DP across pods;
  * tensor parallel over "model" -- column-parallel in-projections,
    row-parallel out-projections, vocab-sharded embed/head;
  * expert parallel over "model" -- MoE expert stacks shard on E;
  * ZeRO-1: AdamW m/v additionally shard a replicated dim over "data";
  * every rule checks divisibility and falls back to replication, so any
    (arch x mesh) combination runs.

Long-context decode (batch 1) can't batch-shard: attention caches shard
their sequence dim instead (sequence-parallel KV).

The rules are written as the JAX package writes them, as a *spec*: one
entry per tensor dim, ``None``, an axis name or a tuple of axis names
(a ``PartitionSpec``'s entries).  What the public functions return is
DTensor's form of the same thing, *placements*: one per mesh dim,
``Shard(i)`` where the spec names that mesh axis on tensor dim ``i``
(a tuple names several mesh dims on one tensor dim), ``Replicate()``
elsewhere.  :func:`spec_of` turns placements back into the spec, which
is how the tests compare the two packages.

``mesh`` is a ``DeviceMesh`` or a :class:`MeshShape` (names and sizes
only), so the rules run without a process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

# parameter name -> (sharded_dim_from_end, kind)
_COL = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_x", "w_r", "w_i",
        "w_ukv", "vision_proj", "lm_head")
_ROW = ("wo", "w_down", "out_proj", "w_out")
_REPL = ("router", "conv_w", "conv_b", "A_log", "dt_bias", "D_skip", "a_param",
         "norm", "bias", "ckv_norm", "w_dkv", "bq", "bk", "bv")

Placements = Tuple[Placement, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices: what the rules
    read of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``)."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`, in
    mesh-dim order (the JAX ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _divisible(dim: int, sizes: Dict[str, int], axis: str) -> bool:
    return axis in sizes and dim % sizes[axis] == 0


def _leaf_name(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def placements(spec, mesh) -> Placements:
    """A spec (one entry per tensor dim) as one placement per mesh dim."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[names.index(axis)] = Shard(i)
    return tuple(out)


def on_mesh(pls: Placements, mesh) -> Placements:
    """``pls`` as a ``DTensor`` on ``mesh`` takes them: a mesh dim of one
    rank holds the whole tensor whatever it names, so it is
    ``Replicate()`` there (torch 2.11's DTensor refuses to flatten a dim
    sharded even over one rank, e.g. an einsum's batch dims).  Every
    placement the port gives a ``DTensor`` passes through here; the
    rules and :func:`spec_of` keep the names, as the JAX specs do."""
    return tuple(Replicate() if n == 1 else p for n, p in zip(tuple(mesh.shape), pls))


def spec_of(pls: Placements, mesh) -> Tuple[Any, ...]:
    """Placements back to the spec, trailing ``None`` entries dropped: a
    tensor dim sharded over one mesh axis is its name, over several the
    tuple of them in mesh-dim order."""
    axes: Dict[int, list] = {}
    for name, p in zip(mesh.mesh_dim_names, pls):
        if isinstance(p, Shard):
            axes.setdefault(p.dim, []).append(name)
    n = max(axes, default=-1) + 1
    return tuple(None if i not in axes else
                 (axes[i][0] if len(axes[i]) == 1 else tuple(axes[i])) for i in range(n))


# ------------------------------------------------------------------ rules
def _param_spec(name: str, shape: Tuple[int, ...], sizes: Dict[str, int],
                replicate_keywords: Tuple[str, ...] = ()) -> list:
    leaf = name.split("/")[-1]
    if leaf == "codes" and len(name.split("/")) >= 2:
        leaf = name.split("/")[-2]       # int8 codes shard like their weight
    elif leaf == "scale":
        return []                        # per-channel scales are tiny
    if any(k in leaf for k in replicate_keywords):
        return []
    stacked = name.startswith("units/")          # leading unit dim
    nd = len(shape)
    base: list = [None] * nd
    off = 1 if stacked else 0
    in_experts = "/experts/" in name

    def set_if(idx: int, axis: str):
        if 0 <= idx < nd and _divisible(shape[idx], sizes, axis):
            base[idx] = axis

    if leaf == "tok":                             # embed (V, D): shard vocab
        set_if(off + 0, "model")
    elif in_experts:                              # (U, E, D, F): expert parallel
        set_if(off + 0, "model")
    elif any(k in leaf for k in _REPL):
        pass
    elif leaf in _COL or leaf == "lm_head":
        set_if(nd - 1, "model")                   # column parallel (output dim)
    elif leaf in _ROW:
        set_if(nd - 2, "model")                   # row parallel (input dim)
    elif nd >= 2:
        set_if(nd - 1, "model")
    return base


def param_spec(name: str, shape: Tuple[int, ...], mesh,
               replicate_keywords: Tuple[str, ...] = ()) -> Placements:
    """Placements of one parameter, identified by its tree path."""
    return placements(_param_spec(name, tuple(shape), axis_sizes(mesh), replicate_keywords),
                      mesh)


def _opt_spec(pspec: list, shape: Tuple[int, ...], sizes: Dict[str, int]) -> list:
    base = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (s, d) in enumerate(zip(base, shape)):
        if s is None and _divisible(d, sizes, "data") and d >= sizes["data"]:
            base[i] = "data"
            break
    return base


def opt_spec(pls: Placements, shape: Tuple[int, ...], mesh) -> Placements:
    """ZeRO-1: shard one replicated dim of m/v over 'data'."""
    return placements(_opt_spec(list(spec_of(pls, mesh)), tuple(shape), axis_sizes(mesh)),
                      mesh)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_spec(batch: int, mesh) -> Any:
    """Spec entry for a batch dim: full DP if divisible, partial, or
    replicated (``None``)."""
    sizes = axis_sizes(mesh)
    axes = dp_axes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    if batch % total == 0:
        return axes if len(axes) > 1 else axes[0]
    if batch % sizes["data"] == 0:
        return "data"
    return None


def tp_replicate_keywords(cfg, mesh) -> Tuple[str, ...]:
    """Params to exclude from tensor parallelism for this (arch, mesh).

    Mamba-2's head count (e.g. 24) rarely divides the model axis:
    splitting d_inner mid-head would reshard every segment of the fused
    in_proj, so such archs run the mixer data-parallel only.  With fewer
    kv heads than model shards a single head would split across ranks,
    so the small kv projections are replicated (standard TP practice)."""
    model = axis_sizes(mesh).get("model", 1)
    out: Tuple[str, ...] = ()
    if cfg is not None and "ssm" in cfg.layer_pattern:
        from repro_torch.models.ssm import n_heads

        if n_heads(cfg) % model != 0:
            out = out + ("in_proj", "out_proj")
    if cfg is not None and not cfg.use_mla and 0 < cfg.num_kv_heads < model:
        out = out + ("wk", "wv", "bk", "bv")
    return out


def _fsdp_spec(pspec: list, shape: Tuple[int, ...], sizes: Dict[str, int]) -> list:
    base = list(pspec) + [None] * (len(shape) - len(pspec))
    cand = [i for i, (s, d) in enumerate(zip(base, shape))
            if s is None and _divisible(d, sizes, "data")]
    if cand:
        base[max(cand, key=lambda i: shape[i])] = "data"
    return base


def fsdp_spec(pls: Placements, shape: Tuple[int, ...], mesh) -> Placements:
    """FSDP: additionally shard the largest replicated dim over 'data'."""
    return placements(_fsdp_spec(list(spec_of(pls, mesh)), tuple(shape), axis_sizes(mesh)),
                      mesh)


def _is_record(tree) -> bool:
    """A ``NamedTuple`` such as ``AdamWState``: its fields are subtrees."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    return fn(path, tree)


def params_shardings(params: Any, mesh, cfg=None) -> Any:
    """Tree of placements matching a params (or grads, or int8 store)
    tree; its leaves need only ``shape``."""
    repl = tp_replicate_keywords(cfg, mesh)
    use_fsdp = bool(getattr(cfg, "fsdp", False))

    def one(path, leaf):
        pls = param_spec(_leaf_name(path), leaf.shape, mesh, repl)
        if use_fsdp and len(leaf.shape) >= 2:
            pls = fsdp_spec(pls, leaf.shape, mesh)
        return pls

    return _map_with_path(one, params)


def opt_state_shardings(opt_state: Any, params: Any, mesh) -> Any:
    """AdamW state (``training.optimizer.AdamWState``): step replicated;
    m/v like params (without the per-arch replication keywords, as in
    the JAX package) + the ZeRO-1 data shard."""
    def mv(path, leaf):
        pls = param_spec(_leaf_name(path), leaf.shape, mesh)
        return opt_spec(pls, leaf.shape, mesh)

    return type(opt_state)(step=replicated(mesh), m=_map_with_path(mv, opt_state.m),
                           v=_map_with_path(mv, opt_state.v))


def cache_shardings(cache: Any, mesh, batch: int) -> Any:
    """KV/SSM/LRU caches: batch-shard when possible, else sequence-shard."""
    sizes = axis_sizes(mesh)
    bspec = batch_spec(batch, mesh)

    def one(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        off = 1 if name.startswith("units/") else 0
        base: list = [None] * nd
        if bspec is not None:
            base[off] = bspec
        leafname = name.split("/")[-1]
        if leafname in ("k", "v", "k_scale", "v_scale"):  # (U, B, cap, KH, hd|1)
            # sequence-parallel KV: the cache's seq dim shards over "model";
            # heads stay whole
            if _divisible(shape[off + 1], sizes, "model"):
                base[off + 1] = "model"
            elif _divisible(shape[off + 2], sizes, "model"):
                base[off + 2] = "model"
            if bspec is None and _divisible(shape[off + 1], sizes, "data") \
                    and base[off + 1] is None:
                base[off + 1] = "data"
        elif leafname in ("ckv", "k_rope"):        # (U, B, cap, r)
            if _divisible(shape[off + 1], sizes, "model"):
                base[off + 1] = "model"
            elif bspec is None and _divisible(shape[off + 1], sizes, "data"):
                base[off + 1] = "data"
        elif leafname == "state" and nd - off == 4:  # ssm (U,B,H,N,P)
            if _divisible(shape[off + 1], sizes, "model"):
                base[off + 1] = "model"
        elif leafname == "state" and nd - off == 2:  # rglru (U,B,W)
            if _divisible(shape[off + 1], sizes, "model"):
                base[off + 1] = "model"
        elif leafname == "conv":                   # (U,B,K-1,C)
            if _divisible(shape[off + 2], sizes, "model"):
                base[off + 2] = "model"
        elif leafname == "len":
            base = [None] * nd
            if bspec is not None:
                base[off] = bspec
        return placements(base, mesh)

    return _map_with_path(one, cache)


def data_shardings(batch: Dict[str, Any], mesh) -> Dict[str, Placements]:
    """tokens/labels (B,S), patch_embeds (B,P,D), a decode's pos (B,)."""
    out = {}
    for k, v in batch.items():
        spec = [batch_spec(v.shape[0], mesh)] + [None] * (len(v.shape) - 1)
        out[k] = placements(spec, mesh)
    return out


def replicated(mesh) -> Placements:
    return (Replicate(),) * len(tuple(mesh.mesh_dim_names))


# ------------------------------------------------------------- placement
def _local_shape(shape: Tuple[int, ...], pls: Placements, mesh) -> Tuple[int, ...]:
    """The shape one rank holds: every sharded dim divided by its mesh
    dims' sizes (the rules only shard dims they divide)."""
    out = list(shape)
    for size, p in zip(tuple(mesh.shape), pls):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {shape} does not divide over {size}")
            out[p.dim] //= size
    return tuple(out)


def shard_offsets(x: DTensor) -> Tuple[int, ...]:
    """Where this rank's shard of ``x`` starts in each dim of the whole
    tensor (the rules' even shards; a dim split over several mesh dims is
    split in mesh-dim order)."""
    mesh, local = x.device_mesh, x.to_local().shape
    coord = mesh.get_coordinate()
    out = []
    for d in range(x.ndim):
        o = 0
        for c, size, p in zip(coord, tuple(mesh.shape), x.placements):
            if p.is_shard(d):
                o = o * size + c
        out.append(o * local[d])
    return tuple(out)


def distribute_tree(tree: Any, shardings: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` as a ``DTensor`` on ``mesh`` with
    the placements of the same path in ``shardings`` (a NamedTuple's
    fields are subtrees: an ``AdamWState`` by ``opt_state_shardings``).
    A real tensor is scattered by ``distribute_tensor`` (every rank passes
    the same full tensor); a ``meta`` tensor becomes ``DTensor.from_local``
    of a meta local shard with the global shape and stride, which
    allocates nothing.  Non-tensor leaves pass through.  The placements go
    through :func:`on_mesh` first."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor) or isinstance(leaf, DTensor):
            return leaf
        pls = on_mesh(_lookup(shardings, path), mesh)
        if leaf.device.type == "meta":
            local = torch.empty(_local_shape(tuple(leaf.shape), pls, mesh), dtype=leaf.dtype,
                                device="meta")
            return DTensor.from_local(local, mesh, pls, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())
        return distribute_tensor(leaf, mesh, pls)

    return _map_with_path(one, tree)


def _lookup(tree, path: Tuple[str, ...]):
    for k in path:
        tree = getattr(tree, k) if _is_record(tree) else tree[k]
    return tree


def local_bytes(tree: Any) -> int:
    """Bytes one rank holds of ``tree``: a ``DTensor`` leaf counts its
    local shard, a plain tensor all of it."""
    total = 0

    def one(_path, leaf):
        nonlocal total
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    _map_with_path(one, tree)
    return total


def sharded_bytes(tree: Any, shardings: Any, mesh) -> int:
    """Bytes one rank would hold of a plain ``tree`` placed by
    ``shardings``, without placing it."""
    total = 0

    def one(path, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            n = 1
            for d in _local_shape(tuple(leaf.shape), _lookup(shardings, path), mesh):
                n *= d
            total += n * leaf.element_size()
        return leaf

    _map_with_path(one, tree)
    return total
