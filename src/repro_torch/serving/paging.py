"""Block-paged KV cache pool under the licensed gateway.

Counterpart of ``repro/serving/paging.py``:

* :class:`BlockAllocator` — host-side free list of physical block ids
  with per-block reference counts and the double-alloc / double-free /
  incref-on-freed guards (a verbatim copy: it is pure Python).
* :class:`PagedCachePool` — the device store.  The pool's leaves come
  from the model's cache (``models.model.init_cache``), classified as
  the JAX pool does by probes: every per-token leaf (GQA ``k``/``v``
  (U, cap, KH, hd) a lane, MLA ``ckv``/``k_rope`` (U, cap, r | rope_d))
  lives as physical blocks ``(U, P+1, bs, ...)`` — the block axis in
  place of the capacity axis, unit axis first, block ``P`` the *null
  block* that absorbs writes of padding rows — addressed through
  per-request block tables; every other leaf is constant-size per-lane
  state (the ``len`` counters, Mamba-2 and RG-LRU conv and state,
  sliding-window rings capped below the pool's capacity), stored
  lane-first ``(num_lanes+1, ...)``, lane ``num_lanes`` being the
  *scratch lane*.  A model with no per-token leaf raises
  :class:`NoPagedLeavesError` (the gateway then takes the contiguous
  pool); one with float lane state is not ``prefix_cacheable``.
  ``copy_block`` is the device half of the prefix cache's copy-on-write.

Prefill chunks (and the gather/scatter decode) ``gather`` each lane's
logical cache through its table into a contiguous batch and ``scatter``
it back.  Their tables, lane ids
and fills may be device tensors (the compiled chunk step's static
inputs), so nothing in the step copies from the host.  Decode does not copy:
``decode_cache`` hands the batched step the pool's block tensors by
reference and the kernels write the one new token per lane in place.
The JAX package has to donate those arrays into the step and adopt the
returned ones (``absorb_decode``); here the write already landed, so
``absorb_decode`` only stores the lane state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.models.model import init_cache


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_lane_ids(lanes: Sequence[int], width: int, scratch: int) -> List[int]:
    """Pad a lane-id list to ``width`` with the scratch lane."""
    lanes = list(lanes)
    assert len(lanes) <= width, (len(lanes), width)
    return lanes + [scratch] * (width - len(lanes))


def batch_axes(cfg: ModelConfig, capacity: int) -> Dict[str, int]:
    """Each cache leaf's batch axis, by path ('units/b0/k': 1,
    'tail/t0/state': 0): the one axis that differs between
    ``init_cache`` at batch 1 and at batch 2 (probed on the meta device:
    no memory)."""
    one = flatten_params(init_cache(cfg, 1, capacity, device="meta"))
    two = flatten_params(init_cache(cfg, 2, capacity, device="meta"))
    out = {}
    for name, t in one.items():
        diff = [i for i, (a, b) in enumerate(zip(t.shape, two[name].shape)) if a != b]
        assert len(diff) == 1, f"cache leaf {name} without a unique batch axis"
        out[name] = diff[0]
    return out


class NoPagedLeavesError(ValueError):
    """The model's cache holds no per-token leaf to page (attention-free,
    or every attention window is below the pool's capacity).  The
    gateway catches exactly this to fall back to the contiguous pool;
    other geometry errors stay plain ``ValueError``."""


class BlockAllocator:
    """Free list of physical cache blocks with double-alloc/free guards
    and per-block reference counts.

    Allocation is all-or-nothing (``alloc`` returns ``None`` rather than a
    partial grant) so a caller never holds a half-provisioned request.
    A freshly allocated block holds one reference; ``incref``/``decref``
    manage shared holders and the block returns to the free list when the
    last reference drops.  ``incref`` on a block that is not live raises,
    and the hard :meth:`free` refuses blocks with other live references.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks))
        self._ref: Dict[int, int] = {}   # live block id -> reference count
        self.alloc_count = 0             # cumulative blocks ever allocated

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._ref)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Atomically allocate ``n`` blocks; None if the pool can't cover it."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._ref[b] = 1
        self.alloc_count += n
        return got

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def incref(self, block: int) -> int:
        if block not in self._ref:
            raise ValueError(f"incref of unallocated block {block}")
        self._ref[block] += 1
        return self._ref[block]

    def decref(self, block: int) -> int:
        """Drop one reference; the block is freed when the count reaches
        zero.  Returns the remaining count; over-release raises."""
        if block not in self._ref:
            raise ValueError(f"decref of unallocated block {block}")
        self._ref[block] -= 1
        left = self._ref[block]
        if left == 0:
            del self._ref[block]
            self._free.append(block)
        return left

    def free(self, blocks: Sequence[int]) -> None:
        """Return exclusively-held blocks; double-frees, foreign ids and
        blocks with live shared references raise."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"free of unallocated block {b}")
            if self._ref[b] != 1:
                raise ValueError(
                    f"free of block {b} with {self._ref[b]} live refs; "
                    f"shared blocks must be released via decref")
            del self._ref[b]
            self._free.append(b)

    def stats(self) -> Dict[str, int]:
        return {"num_blocks": self.num_blocks, "free": self.num_free,
                "held": self.num_held, "alloc_count": self.alloc_count,
                "shared": sum(1 for c in self._ref.values() if c > 1)}


class PagedCachePool:
    """Block-paged cache store behind per-request block tables.

    ``num_lanes`` per-lane state slots, ``capacity`` logical tokens per
    request, ``block_size`` tokens per block and ``num_blocks`` physical
    blocks shared by every lane and license tier (at least one full
    request's worth, the preemption policy's termination guarantee).

    ``leaves`` maps each paged leaf's path (``units/b0/k``, ...) to its
    block tensor, ``state`` each other leaf's path to its lane-first
    tensor; ``pool.k``, ``pool.ckv``, ... name a paged leaf by its last
    path part where that is unique.
    """

    def __init__(self, cfg: ModelConfig, num_lanes: int, capacity: int,
                 block_size: int, num_blocks: int, *, device="cuda"):
        self.cfg = cfg
        self.num_lanes = int(num_lanes)
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.blocks_per_lane = cdiv(self.capacity, self.block_size)
        if self.num_blocks < self.blocks_per_lane:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold one full request "
                f"({self.blocks_per_lane} blocks of {self.block_size})")
        self.allocator = BlockAllocator(self.num_blocks)
        self.device = torch.device(device)
        # classify the cache's leaves by probing init_cache (on the meta
        # device) at the padded capacity and one block more, as the JAX
        # pool does: a leaf that grows by exactly one block along the axis
        # after its batch axis is per-token and paged; anything else is
        # per-lane state (a window ring capped below the capacity
        # included, even when the probe's extra block crosses the window)
        cap = self.padded_capacity
        template = flatten_params(init_cache(cfg, 1, cap, device="meta"))
        grown = flatten_params(init_cache(cfg, 1, cap + self.block_size, device="meta"))
        self._axis = batch_axes(cfg, cap)
        self.leaves: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self._template: Dict[str, torch.Tensor] = template
        for path, t in template.items():
            ax = self._axis[path]
            diff = [i for i, (a, b) in enumerate(zip(t.shape, grown[path].shape)) if a != b]
            if diff == [ax + 1] and grown[path].shape[ax + 1] - t.shape[ax + 1] == self.block_size:
                self.leaves[path] = torch.zeros(
                    (*t.shape[:ax], self.num_blocks + 1, self.block_size, *t.shape[ax + 2:]),
                    dtype=t.dtype, device=self.device)
            else:
                shape = t.shape[:ax] + t.shape[ax + 1:]
                self.state[path] = torch.zeros((self.num_lanes + 1, *shape), dtype=t.dtype,
                                               device=self.device)
        if not self.leaves:
            raise NoPagedLeavesError(
                f"{cfg.name}: no per-token cache leaves to page; use the contiguous "
                f"CachePool instead")
        # a prefix chain (blocks only) can seed a new request iff every
        # per-lane leaf is a counter the gateway can reconstruct; float
        # state (SSM, RG-LRU, window rings) would need a snapshot at the
        # prefix boundary, so such models serve without prefix reuse
        self.prefix_cacheable = all(not t.dtype.is_floating_point
                                    for t in self.state.values())

    def __getattr__(self, name: str) -> torch.Tensor:
        """A paged leaf by its cache name: ``pool.k``, ``pool.ckv``, ..."""
        found = [t for path, t in self.__dict__.get("leaves", {}).items()
                 if path.rsplit("/", 1)[-1] == name]
        if len(found) == 1:
            return found[0]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    # ------------------------------------------------------------- indices
    @property
    def scratch(self) -> int:
        """Scratch lane id absorbing padded per-lane-state writes."""
        return self.num_lanes

    @property
    def null_block(self) -> int:
        """Null block id absorbing padded block-table writes."""
        return self.num_blocks

    @property
    def cache_tokens(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def padded_capacity(self) -> int:
        """Logical tokens a full block table covers."""
        return self.blocks_per_lane * self.block_size

    @property
    def block_bytes(self) -> int:
        """Bytes one physical block occupies across every paged leaf (K
        and V, or MLA's latents and rotary keys) of every unit: the
        exchange rate a fleet-wide cache budget converts between
        different models' blocks with."""
        return sum(t.numel() * t.element_size() // (self.num_blocks + 1)
                   for t in self.leaves.values())

    def pad_lanes(self, lanes: Sequence[int], width: int) -> List[int]:
        return pad_lane_ids(lanes, width, self.scratch)

    def pad_tables(self, tables: Sequence[Sequence[int]], width: int,
                   n_cols: Optional[int] = None) -> np.ndarray:
        """(width, n_cols) int32 table matrix, null-padded.  ``n_cols``
        defaults to ``blocks_per_lane``; decode trims it to the
        micro-batch's used blocks so attention reads O(context)."""
        n_cols = self.blocks_per_lane if n_cols is None else int(n_cols)
        assert len(tables) <= width, (len(tables), width)
        out = np.full((width, n_cols), self.null_block, np.int32)
        for i, t in enumerate(tables):
            assert len(t) <= n_cols, (len(t), n_cols)
            out[i, : len(t)] = t
        return out

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool: the paged leaves and the lane state."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.leaves.values(), *self.state.values()))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _index(self, a) -> torch.Tensor:
        """An int64 device index: a host array is copied over; a device
        tensor (a compiled step's static input) is used where it lies, so
        the gather and scatter below stay capturable."""
        if isinstance(a, torch.Tensor):
            return a.long()
        return self._tensor(a).long()

    # ------------------------------------------------------- gather/scatter
    def _lane_rows(self, path: str, lanes) -> torch.Tensor:
        """Per-lane leaf ``path`` of ``lanes`` in the model's layout (the
        lane at the leaf's batch axis)."""
        return self.state[path][self._index(lanes)].movedim(0, self._axis[path])

    def gather(self, tables, lanes=None) -> Dict[str, Any]:
        """Contiguous per-lane views: ``tables`` (B, T) (host, or int32
        on the device) -> each paged leaf (U, B, T*bs, ...) in logical
        order.  Without ``lanes`` the per-lane leaves are fresh zeros,
        the ``init_cache`` value (a prefill chunk masks positionally and
        the gateway pins the counters to the true fill afterwards); with
        ``lanes`` they are those lanes' state (the gather/scatter decode)."""
        tab = self._index(tables)
        b, t = tab.shape
        out = {}
        for path, like in self._template.items():
            ax = self._axis[path]
            if path in self.leaves:
                g = self.leaves[path][(slice(None),) * ax + (tab,)]
                out[path] = g.reshape(*g.shape[:ax], b, t * self.block_size,
                                      *g.shape[ax + 3:])
            elif lanes is None:
                out[path] = torch.zeros((*like.shape[:ax], b, *like.shape[ax + 1:]),
                                        dtype=like.dtype, device=self.device)
            else:
                out[path] = self._lane_rows(path, lanes).contiguous()
        return unflatten(out)

    def scatter(self, lanes, tables, caches: Dict[str, Any]) -> None:
        """Write chunk views back: paged leaves through the tables, the
        per-lane leaves by lane id (each host, or a device tensor).
        Padding rows target the null block / scratch lane, so duplicate
        pad indices never race a live lane."""
        tab = self._index(tables)
        b, t = tab.shape
        lane_idx = self._index(lanes)
        for path, c in flatten_params(caches).items():
            ax = self._axis[path]
            if path in self.leaves:
                x = self.leaves[path]
                x[(slice(None),) * ax + (tab,)] = c.reshape(
                    *c.shape[:ax], b, t, self.block_size, *c.shape[ax + 2:]).to(x.dtype)
            else:
                x = self.state[path]
                x[lane_idx] = c.movedim(ax, 0).to(x.dtype)

    # ----------------------------------------------- kernel-resident decode

    def decode_cache(self, lanes) -> Dict[str, Any]:
        """Cache dict for the batched kernel-resident decode step: the
        pool's block tensors by reference plus the lanes' per-lane leaves
        (``len`` (U, B), any recurrent state), gathered.  ``lanes``: host
        lane ids, or an int64 device tensor."""
        return unflatten({path: (self.leaves[path] if path in self.leaves
                                 else self._lane_rows(path, lanes).contiguous())
                          for path in self._template})

    def absorb_decode(self, lanes, caches: Dict[str, Any]) -> None:
        """Adopt a decode step's outputs: its token writes already
        landed in the pool in place; store the lanes' advanced state."""
        lane_idx = self._index(lanes)
        for path, c in flatten_params(caches).items():
            if path in self.leaves:
                assert c is self.leaves[path]
            else:
                x = self.state[path]
                x[lane_idx] = c.movedim(self._axis[path], 0).to(x.dtype)

    # --------------------------------------------------- prefix-cache hooks
    def copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block of every paged leaf across every unit —
        the device half of copy-on-write: a request about to write into a
        shared block gets a private ``dst`` holding identical bytes."""
        for path, x in self.leaves.items():
            lead = (slice(None),) * self._axis[path]
            x[lead + (dst,)] = x[lead + (src,)]

    def override_counters(self, caches: Dict[str, Any], value) -> Dict[str, Any]:
        """Pin the gathered integer per-lane leaves (the ``len`` counters)
        to the true logical fill (``value`` scalar or (B,) per lane, host
        or an int32 device tensor, which is used where it lies): a chunk
        step only counts its own W rows."""
        val = torch.as_tensor(value, dtype=torch.int32, device=self.device)
        flat = flatten_params(caches)
        for path, c in flat.items():
            if path not in self.leaves and not c.dtype.is_floating_point:
                ax = self._axis[path]
                v = val.reshape([-1 if i == ax else 1 for i in range(c.ndim)]) if val.ndim else val
                flat[path] = v.expand_as(c).to(c.dtype).clone()
        return unflatten(flat)

    def stats(self) -> Dict[str, int]:
        st = self.allocator.stats()
        st.update(block_size=self.block_size, cache_tokens=self.cache_tokens,
                  blocks_per_lane=self.blocks_per_lane,
                  num_lanes=self.num_lanes, block_bytes=self.block_bytes)
        return st
