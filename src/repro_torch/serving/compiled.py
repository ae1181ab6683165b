"""The compiled steps of the port: CUDA graphs of every step the gateway
runs on the card.  The kernel-resident paged decode runs through the
paged kernels (``slot.decode_kernels``) or through the plain gather (an
int8 KV cache, which the kernels cannot read, or ``decode_kernels=False``);
the chunked prefill, and the bucket path's gather/scatter decode, bucket
prefill and prefix-hit suffix prefill (below) complete the set.

Counterpart of ``repro/serving/gateway.py::_compiled_paged_decode``.  The
JAX gateway jit-compiles its decode step once per (config, used table
width, sampling variant) and donates the pool into it, so it never pays
a per-operation dispatch.  Here the same step (``engine.serve_step_paged``
with the lane counters' gather and scatter around it) is captured once
per key as a CUDA graph and replayed; one decode step is then a few
input copies and one replay instead of ~80 launches a layer.

* **Keys and lifetime.**  A CUDA graph reads the addresses of the weights
  it was captured on, so its graphs belong to the weights' owner: every
  view in the gateway's ``TierViewCache`` is a :class:`View` carrying a
  :class:`GraphSet` (table width -> graph).  A float or materialized int8
  view has its own and takes it along when the cache evicts or
  invalidates it.  On the in-scan int8 path (the store plus a tier's
  intervals) every tier's view of one version shares the version's set,
  its intervals copied into a static (2, MAX_INTERVALS) buffer before
  each replay, as one JAX compilation serves every view; the set goes
  with the version's last view.  The kernel path buckets the used table
  width to a power of two (:func:`table_width`), so a view holds at most
  ceil(log2(blocks_per_lane)) + 1 graphs.
* **Static inputs**, refilled before every replay by an asynchronous
  copy from pinned host memory (:class:`_Input`): tokens (B, 1) int32,
  positions (B,) int32, lane ids (B,) int64, one (B, T) int32 table per
  width.  Static outputs, one
  pair for every graph: the logits (B, V) f32 and their greedy argmax
  (B,) int32, which the gateway consumes (argmax to the host, sampled
  lanes drawn eagerly from the logits rows) before the next replay.  The
  pool's paged leaves and lane state are written in place and keep their
  storage, so nothing of the pool is copied (the JAX package's donation).
* **Capture.**  One eager warm-up on a side stream, then capture into the
  slot's one memory pool.  The warm-up really runs the step: its K/V
  writes are the ones the replay repeats, and the lane state it advanced
  (counters, and any recurrent state) is put back before the replay.  A
  failed capture or replay raises; nothing falls back to the eager step.
* **Launch counts.**  ``ops.LAUNCHES`` counts what the kernel wrappers
  launch: a warm-up's kernels, never a capture's (``ops.count``) and
  never a replay's, which runs no Python.  What a replay runs is read
  from the device trace (chip_smoke); ``captures`` and ``replays`` are
  counted here.

The chunked prefill (:class:`PrefillGraphs`) is the counterpart of the
JAX package's ``_compiled_prefix_prefill`` on the chunked path: one graph
per (pow2 lane count, pow2 table width), the reference's jit key, per
view as above (per version in-scan), kept in the view's own
``prefill_graphs`` so the decode graphs' keys and counts keep their
meaning.  Inside: the pool's gather through a static table, the chunk
step, the last-row pick, the counters pinned to the lanes' fills, the
scatter through a second static table (the shared-block redirect,
computed on the host), and the picked rows' logits and greedy argmax.
A capture's warm-up is the chunk itself (the scatter sets the counters
a replay would set again), so no replay follows a capture.

The bucket path (:class:`GatherDecodeGraphs`, :class:`BucketPrefillGraphs`,
:class:`SuffixPrefillGraphs`) is the counterpart of the JAX package's
``_compiled_steps`` (the lane-batched bucket prefill and the
gather/scatter decode, on the paged and the contiguous pool) and of
``_compiled_prefix_prefill`` on the bucket path: one graph per view (per
version in-scan) at the fixed (``max_batch``, capacity) or (``max_batch``,
``max_prompt``) shape, the suffix prefill one per (suffix width, view),
kept in the view's ``bucket_graphs`` under (family, *key).  Their static
inputs hold full ``max_batch`` rows: the lane ids, the full block tables
and their write-back twins with the shared-block redirect (computed on
the host), and each family's tokens and positions.  The gather, the
step and the scatter all sit inside the graph; the contiguous pool's
every leaf is lane state, put back around a decode warm-up like the
paged pool's.  The models (the SSD chunk scan, the RG-LRU doubling scan,
rings, MoE dispatch) run no host synchronization, and an integer
position is filled on the device (``layers.device_offset``), so every
route captures as it is.

``ServingEngine``'s steps (:class:`EngineGraphs`) are the counterpart
of the JAX engine's two jits (``repro/serving/engine.py``'s ``_prefill``
and ``_decode``): one prefill graph per (view, lanes, prompt width,
capacity) and one decode graph per (view, lanes, capacity), the jits'
shape keys unbucketed (the right-aligned padding enters the outputs),
kept in the view's ``engine_graphs`` (per tier; one set for every tier
of the in-scan store).  A group's contiguous cache is a static buffer
per (lanes, capacity) that the prefill graph zeroes before it fills it.

The dry run's serving steps (:class:`MeshGraphs`) are the counterpart of
``repro/launch/dryrun.py``'s sharded jits: ``prefill_step`` (with or
without a vision prefix) and ``serve_step`` (float, or in-scan with a
tier's intervals) over one weight tree, as DTensors on a mesh or plain
tensors, one prefill graph per (lanes, prompt width, capacity, patch
count) and one decode graph per (lanes, capacity).  Its static inputs
and cache are placed by the partition rules, and its logits come out
whole.  It shares the engine's contiguous-cache capture
(:class:`_CacheGraphs`).

The backend is a constructor parameter: ``CudaGraphBackend`` on the
card; the CPU tests pass one whose replay re-runs the captured function.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.pytree_io import flatten_params
from repro_torch.kernels import ops
from repro_torch.serving.engine import (prefill_chunk_step, prefill_step, prefill_suffix_step,
                                        serve_step, serve_step_paged, stack_lane_caches)
from repro_torch.serving.quantized import qleaves


def table_width(used: int, cap: int) -> int:
    """The kernel path's table width for a micro-batch using ``used``
    blocks a lane: the next power of two, at most ``cap``
    (``blocks_per_lane``).  The padding columns name the null block, and
    attention reads a lane's columns only up to its length."""
    return min(int(cap), 1 << (int(used) - 1).bit_length())


def _snapshot(pool: Any) -> Dict[str, torch.Tensor]:
    """A copy of the pool's lane state (counters, recurrent state)."""
    return {path: t.clone() for path, t in pool.state.items()}


def _restore(pool: Any, snapshot: Dict[str, torch.Tensor]) -> None:
    """Put :func:`_snapshot`'s copy back, in place."""
    for path, t in snapshot.items():
        pool.state[path].copy_(t)


class GraphSet(dict):
    """Table width -> captured decode step, over the weights ``params``;
    ``prefill`` maps (lanes, table width) -> captured prefill chunk over
    the same weights, ``bucket`` (family, *key) -> the bucket path's
    captured steps (:class:`GatherDecodeGraphs`, :class:`BucketPrefillGraphs`,
    :class:`SuffixPrefillGraphs`) and ``engine`` (family, *key) ->
    ``ServingEngine``'s (:class:`EngineGraphs`)."""

    def __init__(self, params: Any):
        super().__init__()
        self.params = params
        self.prefill: Dict[Tuple[int, int], Any] = {}
        self.bucket: Dict[Tuple[Any, ...], Any] = {}
        self.engine: Dict[Tuple[Any, ...], Any] = {}


class View(tuple):
    """A licensed view ``(params, intervals)``, as ``TierViewCache`` holds
    it, with the :class:`GraphSet` of the decode steps captured on it, its
    prefill chunks (``prefill_graphs``), its bucket-path steps
    (``bucket_graphs``) and the engine's steps (``engine_graphs``)."""

    def __new__(cls, params: Any, intervals: Any, graphs: GraphSet):
        view = super().__new__(cls, (params, intervals))
        view.graphs = graphs
        view.prefill_graphs = graphs.prefill
        view.bucket_graphs = graphs.bucket
        view.engine_graphs = graphs.engine
        return view


class StoreGraphs:
    """The in-scan path's graph sets, one per int8 store version, held
    weakly: a set lives while a view of its version holds it."""

    def __init__(self):
        self._sets: "weakref.WeakValueDictionary[Optional[int], GraphSet]" = \
            weakref.WeakValueDictionary()

    def get(self, version: Optional[int], store: Any) -> GraphSet:
        sets = self._sets.get(version)
        if sets is None or sets.params is not store:   # new or replaced weights
            sets = self._sets[version] = GraphSet(store)
        return sets


class CudaGraphBackend:
    """``torch.cuda.CUDAGraph`` capture and replay, every graph of one
    slot in one memory pool (replays are serialized on one stream).

    The pool is a ``torch.cuda.MemPool`` the backend holds for its life.
    A bare ``graph_pool_handle()`` counts only its live graphs as users:
    once every graph of the pool is dropped (a version's views at a
    flip) while tensors it allocated live on, the next capture into it
    fails the caching allocator's ``use_count > 0`` assertion."""

    def __init__(self, device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self._mempool = torch.cuda.MemPool()
        self.pool = self._mempool.id
        self.stream = torch.cuda.Stream(self.device)

    def warmup(self, fn: Callable[[], None]) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], None]) -> Any:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            fn()
        return graph

    @staticmethod
    def replay(graph: Any) -> None:
        graph.replay()

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in this backend's pool (its segments
        in ``torch.cuda.memory_snapshot``)."""
        want = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == want)


class _Input:
    """A static device input, refilled by an asynchronous copy from a
    fresh pinned host tensor.  PyTorch's pinned-memory cache reuses that
    tensor's block only once the copy has run, so a loop that does not
    wait for the card between its steps (the training loops) never
    rewrites host memory that a queued copy is still to read.

    With ``mesh`` the input is a ``DTensor`` placed by
    ``sharding.data_shardings`` (its lanes over the data axes): the
    values given are whole, and each rank copies its own rows into its
    local shard."""

    def __init__(self, shape, dtype, device: torch.device, mesh: Any = None):
        self.dev = self.local = torch.zeros(shape, dtype=dtype, device=device)
        self.rows = slice(None)
        self.pinned = device.type == "cuda"
        try:        # None for a dtype numpy lacks (bf16): filled from the device only
            self.np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        except TypeError:
            self.np_dtype = None
        if mesh is not None:
            from repro_torch.distribution import sharding as shd

            self.dev = shd.distribute_tree({"x": self.local},
                                           shd.data_shardings({"x": self.local}, mesh), mesh)["x"]
            self.local = self.dev.to_local()
            start = shd.shard_offsets(self.dev)[0]
            self.rows = slice(start, start + self.local.shape[0])

    def fill(self, values) -> None:
        """Refill the leading ``len(values)`` rows (all of them for the
        decode step; a prefill chunk's ``b`` lanes) from host values, or
        from a tensor on the device, copied there."""
        if isinstance(values, torch.Tensor):
            src = values[self.rows]
            self.local[:len(src)].copy_(src)
            return
        if self.np_dtype is None:
            raise TypeError(f"a {self.local.dtype} input is filled from a tensor, not host values")
        host = torch.from_numpy(np.ascontiguousarray(values, dtype=self.np_dtype))[self.rows]
        if self.pinned:
            host = host.pin_memory()
        self.local[:len(host)].copy_(host, non_blocking=True)


def _load_intervals(static: torch.Tensor, intervals) -> None:
    """Copy a view's tier intervals into the static (2, MAX_INTERVALS)
    input; zeros (inert intervals) for a tier that masks nothing."""
    if intervals is None:
        static.zero_()
    else:
        static[0].copy_(intervals[0])
        static[1].copy_(intervals[1])


class _StepGraphs:
    """What a slot's compiled steps share.

    ``slot`` is the ``ModelSlot`` whose pool, config, geometry and views
    the graphs use; ``backend`` captures and replays (default:
    ``CudaGraphBackend`` on the slot's device).  Holds the in-scan
    intervals' static (2, MAX_INTERVALS) input, the static outputs (the
    logits rows (B, V) f32 and their greedy argmax (B,) int32, B =
    ``max_batch``) and the capture and replay counts."""

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        self.slot = slot
        dev = slot.device
        self.backend = backend if backend is not None else CudaGraphBackend(dev)
        b = slot.max_batch
        self.intervals = torch.zeros((2, ops.MAX_INTERVALS), dtype=torch.float32, device=dev)
        self.logits = torch.zeros((b, slot.cfg.padded_vocab), dtype=torch.float32, device=dev)
        self.greedy = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.captures = 0
        self.replays = 0

    @property
    def in_scan(self) -> bool:
        return self.slot.quantized and not self.slot.materialize_int8_views

    def __len__(self) -> int:
        return len(self.keys())

    def _load_intervals(self, intervals) -> None:
        """In-scan: copy the view's tier intervals into the static input."""
        if self.in_scan:
            _load_intervals(self.intervals, intervals)

    def _static_intervals(self):
        return (self.intervals[0], self.intervals[1]) if self.in_scan else None

    def _capture_replayed(self, fn: Callable[[], None]) -> Any:
        """Warm up and capture ``fn``, then put back the lane state the
        warm-up advanced: the caller replays the graph for this step."""
        state = _snapshot(self.slot.pool)
        try:
            self.backend.warmup(fn)
            graph = self.backend.capture(fn)
        finally:
            _restore(self.slot.pool, state)
        self.captures += 1
        return graph

    def _capture_ran(self, fn: Callable[[], None]) -> Any:
        """Warm up and capture ``fn``; the warm-up is this step, so its
        writes and lane state stand (a replay would write the same
        again), and only a failed capture puts the lane state back."""
        state = _snapshot(self.slot.pool)
        try:
            self.backend.warmup(fn)
            graph = self.backend.capture(fn)
        except BaseException:
            _restore(self.slot.pool, state)
            raise
        self.captures += 1
        return graph


class DecodeGraphs(_StepGraphs):
    """A slot's compiled decode step (see the module docstring)."""

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        b, dev = slot.max_batch, slot.device
        self.tokens = _Input((b, 1), torch.int32, dev)
        self.positions = _Input((b,), torch.int32, dev)
        self.lanes = _Input((b,), torch.int64, dev)
        self.tables: Dict[int, _Input] = {}

    def keys(self) -> set:
        """The live graphs' keys, read from the views that own them:
        (tier, version, width), or (version, width) in-scan."""
        return {(k[1], w) if self.in_scan else (*k, w)
                for k, view in self.slot.views._entries.items() for w in view.graphs}

    def step(self, view: View, tokens: np.ndarray, positions: np.ndarray,
             lanes: Sequence[int], tables: np.ndarray):
        """One decode step through ``view``'s graph for the width of
        ``tables``, captured on first use.  Host arguments as the eager
        step's: tokens (B, 1), positions (B,), lane ids (B,), tables
        (B, T).  Returns the static logits (B, V) and greedy tokens (B,),
        valid until the next step."""
        params, intervals = view
        width = int(tables.shape[1])
        self.tokens.fill(tokens)
        self.positions.fill(positions)
        self.lanes.fill(lanes)
        if width not in self.tables:
            self.tables[width] = _Input((self.slot.max_batch, width), torch.int32,
                                        self.slot.device)
        self.tables[width].fill(tables)
        self._load_intervals(intervals)
        graph = view.graphs.get(width)
        if graph is None:
            graph = view.graphs[width] = self._capture(params, self.tables[width])
        self.backend.replay(graph)
        self.replays += 1
        return self.logits, self.greedy

    def _capture(self, params: Any, table: _Input) -> Any:
        slot, pool = self.slot, self.slot.pool
        li = self._static_intervals()

        def step():
            cache = pool.decode_cache(self.lanes.dev)
            logits, cache = serve_step_paged(params, slot.cfg, self.tokens.dev, cache,
                                             table.dev, self.positions.dev, li,
                                             kernel=slot.decode_kernels)
            pool.absorb_decode(self.lanes.dev, cache)
            self.logits.copy_(logits)
            self.greedy.copy_(torch.argmax(logits, -1))

        return self._capture_replayed(step)


class PrefillGraphs(_StepGraphs):
    """A slot's compiled chunked-prefill step (see the module docstring).

    Static inputs hold ``max_batch`` rows; a graph for ``b`` lanes reads
    their leading ``b``: chunk tokens (B, W) int32, cursors (B,) int32,
    last real rows (B,) int64, fills (B,) int32, lane ids (B,) int64, and
    per table width a gather and a scatter table (B, T) int32.  Its
    static outputs are the picked rows' logits and greedy tokens."""

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        b, w, dev = slot.max_batch, slot.chunk_size, slot.device
        self.tokens = _Input((b, w), torch.int32, dev)
        self.cursors = _Input((b,), torch.int32, dev)
        self.lasts = _Input((b,), torch.int64, dev)
        self.fills = _Input((b,), torch.int32, dev)
        self.lanes = _Input((b,), torch.int64, dev)
        self.tables: Dict[int, Tuple[_Input, _Input]] = {}

    def keys(self) -> set:
        """The live graphs' keys, read from the views that own them:
        (tier, version, lanes, width), or (version, lanes, width) in-scan."""
        return {(k[1], *key) if self.in_scan else (*k, *key)
                for k, view in self.slot.views._entries.items()
                for key in view.prefill_graphs}

    def step(self, view: View, tokens: np.ndarray, cursors: np.ndarray,
             lasts: np.ndarray, fills: np.ndarray, lanes: Sequence[int],
             tables: np.ndarray, scatter_tables: np.ndarray):
        """One prefill chunk through ``view``'s graph for (lanes, width)
        of ``tables``, captured on first use.  Host arguments as the eager
        chunk's, each ``b`` rows: tokens (b, W), cursors, last real rows,
        fills, padded lane ids, and the gather and write-back tables
        (b, T).  Returns the static picked-row logits (b, V) and greedy
        tokens (b,), valid until the next chunk."""
        params, intervals = view
        b, width = (int(n) for n in tables.shape)
        for buf, values in ((self.tokens, tokens), (self.cursors, cursors),
                            (self.lasts, lasts), (self.fills, fills),
                            (self.lanes, lanes)):
            buf.fill(values)
        if width not in self.tables:
            shape = (self.slot.max_batch, width)
            self.tables[width] = (_Input(shape, torch.int32, self.slot.device),
                                  _Input(shape, torch.int32, self.slot.device))
        gather, scatter = self.tables[width]
        gather.fill(tables)
        scatter.fill(scatter_tables)
        self._load_intervals(intervals)
        graph = view.prefill_graphs.get((b, width))
        if graph is None:
            # the capture's warm-up ran this chunk: its outputs stand
            view.prefill_graphs[(b, width)] = self._capture(params, b, gather, scatter)
        else:
            self.backend.replay(graph)
            self.replays += 1
        return self.logits[:b], self.greedy[:b]

    def _capture(self, params: Any, b: int, gather: _Input, scatter: _Input) -> Any:
        slot, pool = self.slot, self.slot.pool
        li = self._static_intervals()

        def chunk():
            caches = pool.gather(gather.dev[:b])
            logits, caches = prefill_chunk_step(params, slot.cfg, self.tokens.dev[:b],
                                                caches, self.cursors.dev[:b],
                                                license_intervals=li)
            rows = logits[torch.arange(b, device=logits.device), self.lasts.dev[:b]]
            self.logits[:b].copy_(rows)
            self.greedy[:b].copy_(torch.argmax(rows, -1))
            caches = pool.override_counters(caches, self.fills.dev[:b])
            pool.scatter(self.lanes.dev[:b], scatter.dev[:b], caches)

        return self._capture_ran(chunk)


class _BucketGraphs(_StepGraphs):
    """What the bucket path's families share: their graphs live in the
    views' ``bucket_graphs`` under (``family``, *key), and every step
    fills the static lane ids (B,) int64 and, on the paged pool, the
    gather and write-back tables (B, ``blocks_per_lane``) int32."""

    family = ""

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        b, dev = slot.max_batch, slot.device
        self.lanes = _Input((b,), torch.int64, dev)
        if slot.paged:
            shape = (b, slot.pool.blocks_per_lane)
            self.tables = _Input(shape, torch.int32, dev)
            self.scatter_tables = _Input(shape, torch.int32, dev)

    def keys(self) -> set:
        """The live graphs' keys, read from the views that own them:
        (tier, version, *key), or (version, *key) in-scan."""
        return {(k[1], *key[1:]) if self.in_scan else (*k, *key[1:])
                for k, view in self.slot.views._entries.items()
                for key in view.bucket_graphs if key[0] == self.family}

    def _fill(self, lanes: Sequence[int], tables: Optional[np.ndarray],
              scatter_tables: Optional[np.ndarray]) -> None:
        self.lanes.fill(lanes)
        if tables is not None:
            self.tables.fill(tables)
            self.scatter_tables.fill(scatter_tables)

    def _scatter(self, caches: Dict[str, Any]) -> None:
        """The lanes' caches into the pool: through the write-back tables
        on the paged pool, by lane id on the contiguous one."""
        if self.slot.paged:
            self.slot.pool.scatter(self.lanes.dev, self.scatter_tables.dev, caches)
        else:
            self.slot.pool.scatter(self.lanes.dev, caches)

    def _emit(self, logits: torch.Tensor) -> None:
        self.logits.copy_(logits)
        self.greedy.copy_(torch.argmax(logits, -1))


class GatherDecodeGraphs(_BucketGraphs):
    """A slot's compiled gather/scatter decode, one graph per view (per
    version in-scan): the counterpart of the JAX package's
    ``_compiled_steps`` decode, whose jit key is the fixed gathered shape
    (``max_batch``, capacity).  Inside: each lane's logical cache gathered
    from the pool (through the full tables on the paged pool),
    ``engine.serve_step``, the logits and greedy argmax, and the scatter
    back (through the write-back tables, shared blocks redirected to the
    null block).  Static inputs besides :class:`_BucketGraphs`': tokens
    (B, 1) int32, positions (B,) int32.  The warm-up's lane state is put
    back and the step replayed, as :class:`DecodeGraphs` does."""

    family = "decode"

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        b, dev = slot.max_batch, slot.device
        self.tokens = _Input((b, 1), torch.int32, dev)
        self.positions = _Input((b,), torch.int32, dev)

    def step(self, view: View, tokens: np.ndarray, positions: np.ndarray,
             lanes: Sequence[int], tables: Optional[np.ndarray] = None,
             scatter_tables: Optional[np.ndarray] = None):
        """One decode step through ``view``'s graph, captured on first
        use.  Host arguments as the eager step's: tokens (B, 1),
        positions (B,), lane ids (B,) and, on the paged pool, the tables
        and write-back tables (B, blocks_per_lane).  Returns the static
        logits (B, V) and greedy tokens (B,), valid until the next step."""
        params, intervals = view
        self.tokens.fill(tokens)
        self.positions.fill(positions)
        self._fill(lanes, tables, scatter_tables)
        self._load_intervals(intervals)
        graph = view.bucket_graphs.get((self.family,))
        if graph is None:
            graph = view.bucket_graphs[(self.family,)] = self._capture(params)
        self.backend.replay(graph)
        self.replays += 1
        return self.logits, self.greedy

    def _capture(self, params: Any) -> Any:
        slot, pool = self.slot, self.slot.pool
        li = self._static_intervals()

        def step():
            caches = (pool.gather(self.tables.dev, self.lanes.dev) if slot.paged
                      else pool.gather(self.lanes.dev))
            logits, caches = serve_step(params, slot.cfg, self.tokens.dev, caches,
                                        self.positions.dev, li)
            self._emit(logits)
            self._scatter(caches)

        return self._capture_replayed(step)


class BucketPrefillGraphs(_BucketGraphs):
    """A slot's compiled bucket prefill (``chunk_size=0``), one graph per
    view (per version in-scan) at (``max_batch``, ``max_prompt``): the
    counterpart of the JAX package's ``_compiled_steps`` prefill.  Inside:
    the fresh lane caches (a static ``init_cache`` of ``max_batch`` lanes)
    zeroed in place, ``engine.prefill_step`` on the right-aligned prompts
    (static (B, max_prompt) int32 tokens), the logits and greedy argmax,
    and the scatter into the pool through the lanes' ``prefill_blocks``
    tables.  The warm-up is the step (:meth:`_StepGraphs._capture_ran`),
    so no replay follows a capture."""

    family = "prefill"

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        self.tokens = _Input((slot.max_batch, slot.max_prompt), torch.int32, slot.device)
        self.caches: Optional[Dict[str, Any]] = None     # made at the first capture

    def step(self, view: View, tokens: np.ndarray, lanes: Sequence[int],
             tables: Optional[np.ndarray] = None,
             scatter_tables: Optional[np.ndarray] = None):
        """One bucket prefill through ``view``'s graph, captured on first
        use.  Host arguments: the right-aligned tokens (B, max_prompt),
        the padded lane ids (B,) and, on the paged pool, the lanes'
        tables and write-back tables (B, blocks_per_lane).  Returns the
        static last-row logits (B, V) and greedy tokens (B,)."""
        params, intervals = view
        self.tokens.fill(tokens)
        self._fill(lanes, tables, scatter_tables)
        self._load_intervals(intervals)
        graph = view.bucket_graphs.get((self.family,))
        if graph is None:
            view.bucket_graphs[(self.family,)] = self._capture(params)
        else:
            self.backend.replay(graph)
            self.replays += 1
        return self.logits, self.greedy

    def _capture(self, params: Any) -> Any:
        slot = self.slot
        li = self._static_intervals()
        if self.caches is None:
            self.caches = stack_lane_caches(slot.cfg, slot.max_batch, slot._zero_cap,
                                            slot.device)
        leaves = list(flatten_params(self.caches).values())

        def step():
            for t in leaves:
                t.zero_()
            logits, caches = prefill_step(params, slot.cfg, self.tokens.dev, self.caches,
                                          license_intervals=li)
            self._emit(logits)
            self._scatter(caches)

        return self._capture_ran(step)


class SuffixPrefillGraphs(_BucketGraphs):
    """A slot's compiled prefix-hit bucket prefill, one graph per (suffix
    width, view) (per (width, version) in-scan): the JAX package's
    ``_compiled_prefix_prefill`` key.  Inside: the lanes' caches gathered
    through their tables (adopted blocks by reference),
    ``engine.prefill_suffix_step`` on each lane's uncached suffix at its
    own offset, each lane's last real row picked, its logits and greedy
    argmax, the counters pinned to ``max_prompt`` and the scatter through
    the write-back tables.  Static inputs besides :class:`_BucketGraphs`':
    per width the suffix tokens (B, W) int32, and the offsets (B,)
    int32, last real rows (B,) int64 and fills (B,) int32 (``max_prompt``
    each).  The warm-up is the step, as :class:`BucketPrefillGraphs`'."""

    family = "suffix"

    def __init__(self, slot: Any, backend: Optional[Any] = None):
        super().__init__(slot, backend)
        b, dev = slot.max_batch, slot.device
        self.tokens: Dict[int, _Input] = {}
        self.offsets = _Input((b,), torch.int32, dev)
        self.lasts = _Input((b,), torch.int64, dev)
        self.fills = torch.full((b,), slot.max_prompt, dtype=torch.int32, device=dev)

    def step(self, view: View, tokens: np.ndarray, offsets: np.ndarray,
             lasts: np.ndarray, lanes: Sequence[int], tables: np.ndarray,
             scatter_tables: np.ndarray):
        """One suffix prefill through ``view``'s graph for the width of
        ``tokens`` (B, W), captured on first use.  Host arguments as the
        eager step's: offsets (B,), last real rows (B,), lane ids (B,),
        tables and write-back tables (B, blocks_per_lane).  Returns the
        static picked-row logits (B, V) and greedy tokens (B,)."""
        params, intervals = view
        width = int(tokens.shape[1])
        if width not in self.tokens:
            self.tokens[width] = _Input((self.slot.max_batch, width), torch.int32,
                                        self.slot.device)
        self.tokens[width].fill(tokens)
        self.offsets.fill(offsets)
        self.lasts.fill(lasts)
        self._fill(lanes, tables, scatter_tables)
        self._load_intervals(intervals)
        graph = view.bucket_graphs.get((self.family, width))
        if graph is None:
            view.bucket_graphs[(self.family, width)] = self._capture(params, width)
        else:
            self.backend.replay(graph)
            self.replays += 1
        return self.logits, self.greedy

    def _capture(self, params: Any, width: int) -> Any:
        slot, pool = self.slot, self.slot.pool
        li = self._static_intervals()
        tokens = self.tokens[width]

        def step():
            caches = pool.gather(self.tables.dev)
            logits, caches = prefill_suffix_step(params, slot.cfg, tokens.dev, caches,
                                                 self.offsets.dev, li)
            self._emit(logits[torch.arange(slot.max_batch, device=logits.device),
                              self.lasts.dev])
            self._scatter(pool.override_counters(caches, self.fills))

        return self._capture_ran(step)


def _capture_on_cache(backend: Any, step: Callable[[], None], leaves: Sequence[torch.Tensor],
                      replayed: bool) -> Any:
    """Warm up and capture ``step``, a step over a contiguous cache whose
    leaves (a ``DTensor``'s local shards) are ``leaves``.  A prefill
    (``replayed`` false) zeroes the cache inside its step: the warm-up is
    the prefill and stands, and a failed capture leaves the cache zeroed,
    its pristine state.  A decode's warm-up advanced the cache (its len,
    any recurrent state): the cache is put back, and the caller replays
    the graph for this step."""
    saved = [t.clone() for t in leaves] if replayed else ()
    try:
        backend.warmup(step)
        graph = backend.capture(step)
    except BaseException:
        if not replayed:
            for t in leaves:
                t.zero_()
        raise
    finally:
        for t, s in zip(leaves, saved):
            t.copy_(s)
    return graph


class _CacheGraphs:
    """What the contiguous-cache families (:class:`EngineGraphs`,
    :class:`MeshGraphs`) share: the static inputs by (name, shape), one
    contiguous cache of b lanes per (b, capacity), the in-scan intervals
    (2, MAX_INTERVALS), the static outputs per b (the last-token logits
    (b, V) f32, whole, and their greedy argmax (b,) int32, valid until the
    next step of b lanes), and the prefill and decode captures.  ``mesh``
    (None: plain tensors) places the inputs and the cache by the
    partition rules; the steps then run under ``implicit_replication``."""

    mesh: Any = None

    def __init__(self, cfg: Any, device: Any, backend: Optional[Any] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.backend = backend if backend is not None else CudaGraphBackend(self.device)
        self.intervals = torch.zeros((2, ops.MAX_INTERVALS), dtype=torch.float32,
                                     device=self.device)
        self.inputs: Dict[Tuple[Any, ...], _Input] = {}
        self.caches: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self.keys())

    def _input(self, name: str, shape: Tuple[int, ...], dtype) -> _Input:
        key = (name, *shape)
        if key not in self.inputs:
            self.inputs[key] = _Input(shape, dtype, self.device, self.mesh)
        return self.inputs[key]

    def _fill_step(self, tokens, pos) -> Tuple[_Input, _Input]:
        """A decode step's static tokens (b, 1) and positions (b,) filled:
        ``tokens`` (b,) a tensor on the device (the last step's greedy
        output or draw) or host values, ``pos`` an int or (b,) host
        positions."""
        b = int(tokens.shape[0])
        toks = self._input("tokens", (b, 1), torch.int32)
        poss = self._input("positions", (b,), torch.int32)
        toks.fill(tokens.reshape(b, 1))
        poss.fill(np.array(np.broadcast_to(pos, (b,)), np.int32))
        return toks, poss

    def _static_intervals(self, in_scan: bool, intervals):
        """In-scan: the static intervals filled with ``intervals`` (a
        tier's, None for one that masks nothing); else None."""
        if not in_scan:
            return None
        _load_intervals(self.intervals, intervals)
        return (self.intervals[0], self.intervals[1])

    def _outputs(self, b: int):
        if b not in self.outputs:
            self.outputs[b] = (
                torch.zeros((b, self.cfg.padded_vocab), dtype=torch.float32, device=self.device),
                torch.zeros((b,), dtype=torch.int32, device=self.device))
        return self.outputs[b]

    def _cache(self, b: int, capacity: int) -> Dict[str, Any]:
        if (b, capacity) not in self.caches:
            cache = stack_lane_caches(self.cfg, b, capacity, self.device)
            if self.mesh is not None:
                from repro_torch.distribution import sharding as shd

                cache = shd.distribute_tree(cache, shd.cache_shardings(cache, self.mesh, b),
                                            self.mesh)
            self.caches[(b, capacity)] = cache
        return self.caches[(b, capacity)]

    def _step(self, b: int, capacity: int, run: Callable[[Dict[str, Any]], torch.Tensor],
              replayed: bool) -> Any:
        """Capture ``run`` (the cache -> last-token logits) over the
        (b, capacity) cache, its logits made whole into the static
        outputs; a prefill (``replayed`` false) zeroes the cache first."""
        cache = self._cache(b, capacity)
        leaves = [t.to_local() if isinstance(t, DTensor) else t
                  for t in flatten_params(cache).values()]
        logits_out, greedy = self._outputs(b)
        modes = implicit_replication if self.mesh is not None else contextlib.nullcontext

        def step():
            with modes():
                if not replayed:
                    for t in leaves:
                        t.zero_()
                logits = run(cache)
                if isinstance(logits, DTensor):     # an all-gather where vocab is sharded
                    logits = logits.full_tensor()
                logits_out.copy_(logits)
                greedy.copy_(torch.argmax(logits, -1))

        graph = _capture_on_cache(self.backend, step, leaves, replayed)
        self.captures += 1
        return graph

    def _prefill(self, graphs: Dict[Tuple[Any, ...], Any], key: Tuple[Any, ...], params: Any,
                 li, prompt: _Input, capacity: int, patches: Optional[_Input] = None):
        pe = None if patches is None else patches.dev
        return self._run(graphs, key, prompt.dev.shape[0], capacity, lambda cache: prefill_step(
            params, self.cfg, prompt.dev, cache, patch_embeds=pe, license_intervals=li)[0],
            replayed=False)

    def _decode(self, graphs: Dict[Tuple[Any, ...], Any], key: Tuple[Any, ...], params: Any,
                li, toks: _Input, poss: _Input, capacity: int):
        return self._run(graphs, key, toks.dev.shape[0], capacity, lambda cache: serve_step(
            params, self.cfg, toks.dev, cache, poss.dev, li)[0], replayed=True)

    def _run(self, graphs: Dict[Tuple[Any, ...], Any], key: Tuple[Any, ...], b: int,
             capacity: int, run: Callable[[Dict[str, Any]], torch.Tensor], replayed: bool):
        """Replay ``graphs[key]``, capturing it first (:meth:`_step`); a
        prefill's capture ran the step (its warm-up), so no replay follows
        it.  Returns the static outputs of b lanes."""
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = self._step(b, capacity, run, replayed)
            if not replayed:
                return self._outputs(b)
        self.backend.replay(graph)
        self.replays += 1
        return self._outputs(b)


class EngineGraphs(_CacheGraphs):
    """``ServingEngine``'s compiled prefill and decode (see the module
    docstring).

    ``engine`` is the ``ServingEngine`` whose config, device and views
    the graphs use; ``backend`` captures and replays (default:
    ``CudaGraphBackend`` on the engine's device), every graph in its one
    memory pool.  Static inputs, by shape: the right-aligned prompts (b,
    max_prompt) int32, the decode tokens (b, 1) int32 and positions (b,)
    int32, one contiguous cache of b lanes per (b, capacity), and the
    in-scan intervals (2, MAX_INTERVALS).  A prefill capture's warm-up
    is the prefill (its graph zeroes the cache first, so a replay starts
    from the pristine state, recurrent state included); a decode
    capture's warm-up advances the cache, which is put back before the
    step's replay."""

    def __init__(self, engine: Any, backend: Optional[Any] = None):
        super().__init__(engine.cfg, engine.device, backend)
        self.engine = engine
        # graphs read the static buffers of the set that captured them:
        # a new set drops what the engine's views hold of an older one
        for view in engine._views._entries.values():
            view.engine_graphs.clear()

    def keys(self) -> set:
        """The live graphs' keys, read from the views that own them:
        (tier, "prefill", b, max_prompt, capacity) and (tier, "decode", b,
        capacity); in-scan, where every tier shares one set, without the
        tier."""
        in_scan = self.engine.quantized
        return {key if in_scan else (k[0], *key)
                for k, view in self.engine._views._entries.items()
                for key in view.engine_graphs}

    def prefill(self, view: View, tokens: np.ndarray, capacity: int):
        """The prefill of a group's right-aligned prompts ``tokens`` (b,
        max_prompt) into its cache of ``capacity`` tokens a lane, through
        ``view``'s graph for that key, captured on first use.  Returns the
        static last-token logits (b, V) and greedy tokens (b,)."""
        b, width = (int(n) for n in tokens.shape)
        prompt = self._input("prompt", (b, width), torch.int32)
        prompt.fill(tokens)
        params, li = self._load(view)
        return self._prefill(view.engine_graphs, ("prefill", b, width, int(capacity)), params, li,
                             prompt, int(capacity))

    def decode(self, view: View, tokens: torch.Tensor, pos: int, capacity: int):
        """One decode step of the group's b lanes at position ``pos``:
        ``tokens`` (b,) int32 on the device (the last step's greedy
        output or draw) copied into the static input on the device, the
        positions copied from pinned host memory; through ``view``'s graph
        for (b, capacity), captured on first use.  Returns the static
        logits (b, V) and greedy tokens (b,)."""
        toks, poss = self._fill_step(tokens, pos)
        params, li = self._load(view)
        return self._decode(view.engine_graphs, ("decode", int(tokens.shape[0]), int(capacity)),
                            params, li, toks, poss, int(capacity))

    def _load(self, view: View):
        """``view``'s weights and, in-scan, the static intervals filled
        with its tier's."""
        params, intervals = view
        return params, self._static_intervals(self.engine.quantized, intervals)


class MeshGraphs(_CacheGraphs):
    """The dry run's serving steps compiled: ``prefill_step`` (with or
    without a vision prefix) and ``serve_step`` (float, or in-scan from
    the int8 store with a tier's intervals) as graphs over one weight
    tree, sharded on ``mesh`` or, with none, on plain tensors.

    Counterpart of ``repro/launch/dryrun.py``'s serving jits, each one
    program under ``in_shardings``.  ``params`` are the weights as the
    caller placed them (``sharding.distribute_tree`` by
    ``params_shardings`` on a mesh), and the graphs live on their device.
    An int8 store (any int8 leaf) runs in-scan: its steps read their
    tier's intervals (plain tensors: the sharded dequant takes no
    ``DTensor`` lo/hi) from the static (2, MAX_INTERVALS) input, and a
    float tree refuses intervals.  The float tree and the store each own
    a set.  One prefill graph per (b, prompt width, capacity, patch count
    or None) and one decode graph per (b, capacity).  Static inputs: the
    prompts (b, width) int32, the decode tokens (b, 1) int32 and
    positions (b,) int32 placed by ``data_shardings`` on a mesh, the
    patch embeddings (b, P, d_model) in ``cfg.dtype``, one contiguous
    cache per (b, capacity) from ``init_cache`` placed once by
    ``cache_shardings``.  The logits come out whole (an all-gather over
    the model axis where the vocabulary is sharded; none on one rank).

    The steps run under ``implicit_replication`` on the mesh, warm-up and
    capture included.  Inside a capture they hold DTensor's functional
    collectives, which the warm-up has run once eagerly (NCCL sets up a
    communicator on its first collective, which a capture cannot do)."""

    def __init__(self, cfg: Any, params: Any, *, mesh: Any = None,
                 backend: Optional[Any] = None):
        leaf = next(iter(flatten_params(params).values()))
        self.mesh = mesh
        super().__init__(cfg, (leaf.to_local() if isinstance(leaf, DTensor) else leaf).device,
                         backend)
        self.params = params
        self.in_scan = next(qleaves(params), None) is not None
        self.graphs: Dict[Tuple[Any, ...], Any] = {}

    def keys(self) -> set:
        """("prefill", b, width, capacity, patches or None) and
        ("decode", b, capacity)."""
        return set(self.graphs)

    def prefill(self, tokens: np.ndarray, capacity: int, patch_embeds: Optional[torch.Tensor] = None,
                intervals=None):
        """``prefill_step`` of the prompts ``tokens`` (b, width) after
        the vision prefix ``patch_embeds`` (b, P, d_model), a tensor, if
        one is given, into the (b, ``capacity``) cache; in-scan in the
        tier of ``intervals``.  Returns the static last-token logits (b,
        V) and greedy tokens (b,)."""
        b, width = (int(n) for n in tokens.shape)
        prompt = self._input("prompt", (b, width), torch.int32)
        prompt.fill(tokens)
        patches, n = None, None
        if patch_embeds is not None:
            n = int(patch_embeds.shape[1])
            patches = self._input("patches", (b, n, self.cfg.d_model), self.cfg.dtype)
            patches.fill(patch_embeds)
        return self._prefill(self.graphs, ("prefill", b, width, int(capacity), n), self.params,
                             self._tier(intervals), prompt, int(capacity), patches)

    def decode(self, tokens, pos, capacity: int, intervals=None):
        """One ``serve_step`` of b lanes over the cache the prefill of
        (b, ``capacity``) filled: ``tokens`` (b,) on the device (the last
        step's greedy output) or on the host, ``pos`` an int or (b,)
        positions.  Returns the static logits (b, V) and greedy tokens
        (b,)."""
        toks, poss = self._fill_step(tokens, pos)
        return self._decode(self.graphs, ("decode", int(tokens.shape[0]), int(capacity)),
                            self.params, self._tier(intervals), toks, poss, int(capacity))

    def _tier(self, intervals):
        if intervals is not None and not self.in_scan:
            raise ValueError("a float weight tree takes no license intervals; "
                             "serve a tier in-scan from the int8 store")
        return self._static_intervals(self.in_scan, intervals)
