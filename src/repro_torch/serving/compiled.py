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

The backend is a constructor parameter: ``CudaGraphBackend`` on the
card; the CPU tests pass one whose replay re-runs the captured function.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params
from repro_torch.kernels import ops
from repro_torch.serving.engine import (prefill_chunk_step, prefill_step, prefill_suffix_step,
                                        serve_step, serve_step_paged, stack_lane_caches)


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
    slot in one memory pool (replays are serialized on one stream)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
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
    rewrites host memory that a queued copy is still to read."""

    def __init__(self, shape, dtype, device: torch.device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self.np_dtype = torch.zeros((), dtype=dtype).numpy().dtype
        self.pinned = device.type == "cuda"

    def fill(self, values) -> None:
        """Refill the leading ``len(values)`` rows (all of them for the
        decode step; a prefill chunk's ``b`` lanes)."""
        host = torch.from_numpy(np.ascontiguousarray(values, dtype=self.np_dtype))
        if self.pinned:
            host = host.pin_memory()
        self.dev[:len(host)].copy_(host, non_blocking=True)


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


class EngineGraphs:
    """``ServingEngine``'s compiled prefill and decode (see the module
    docstring).

    ``engine`` is the ``ServingEngine`` whose config, device and views
    the graphs use; ``backend`` captures and replays (default:
    ``CudaGraphBackend`` on the engine's device), every graph in its one
    memory pool.  Static inputs, by shape: the right-aligned prompts (b,
    max_prompt) int32, the decode tokens (b, 1) int32 and positions (b,)
    int32, one contiguous cache of b lanes per (b, capacity), and the
    in-scan intervals (2, MAX_INTERVALS).  Static outputs per b: the
    last-token logits (b, V) f32 and their greedy argmax (b,) int32,
    valid until the next step of b lanes.  A prefill capture's warm-up
    is the prefill (its graph zeroes the cache first, so a replay starts
    from the pristine state, recurrent state included); a decode
    capture's warm-up advances the cache, which is put back before the
    step's replay."""

    def __init__(self, engine: Any, backend: Optional[Any] = None):
        self.engine = engine
        dev = engine.device
        self.backend = backend if backend is not None else CudaGraphBackend(dev)
        self.intervals = torch.zeros((2, ops.MAX_INTERVALS), dtype=torch.float32, device=dev)
        self.prompts: Dict[Tuple[int, int], _Input] = {}
        self.tokens: Dict[int, _Input] = {}
        self.positions: Dict[int, _Input] = {}
        self.caches: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.captures = 0
        self.replays = 0
        # graphs read the static buffers of the set that captured them:
        # a new set drops what the engine's views hold of an older one
        for view in engine._views._entries.values():
            view.engine_graphs.clear()

    def __len__(self) -> int:
        return len(self.keys())

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
        if (b, width) not in self.prompts:
            self.prompts[(b, width)] = _Input((b, width), torch.int32, self.engine.device)
        prompt = self.prompts[(b, width)]
        prompt.fill(tokens)
        params, li = self._load(view)
        key = ("prefill", b, width, int(capacity))
        graph = view.engine_graphs.get(key)
        if graph is None:
            # the capture's warm-up ran this prefill: its outputs stand
            view.engine_graphs[key] = self._capture_prefill(params, li, prompt, int(capacity))
        else:
            self.backend.replay(graph)
            self.replays += 1
        return self._outputs(b)

    def decode(self, view: View, tokens: torch.Tensor, pos: int, capacity: int):
        """One decode step of the group's b lanes at position ``pos``:
        ``tokens`` (b,) int32 on the device (the last step's greedy
        output or draw) copied into the static input on the device, the
        positions copied from pinned host memory; through ``view``'s graph
        for (b, capacity), captured on first use.  Returns the static
        logits (b, V) and greedy tokens (b,)."""
        b = int(tokens.shape[0])
        if b not in self.tokens:
            self.tokens[b] = _Input((b, 1), torch.int32, self.engine.device)
            self.positions[b] = _Input((b,), torch.int32, self.engine.device)
        toks, poss = self.tokens[b], self.positions[b]
        toks.dev.copy_(tokens.reshape(b, 1))
        poss.fill(np.full(b, pos, np.int32))
        params, li = self._load(view)
        key = ("decode", b, int(capacity))
        graph = view.engine_graphs.get(key)
        if graph is None:
            graph = view.engine_graphs[key] = self._capture_decode(params, li, toks, poss,
                                                                   int(capacity))
        self.backend.replay(graph)
        self.replays += 1
        return self._outputs(b)

    def _load(self, view: View):
        """``view``'s weights and, in-scan, the static intervals filled
        with its tier's."""
        params, intervals = view
        if not self.engine.quantized:
            return params, None
        _load_intervals(self.intervals, intervals)
        return params, (self.intervals[0], self.intervals[1])

    def _outputs(self, b: int):
        if b not in self.outputs:
            dev = self.engine.device
            self.outputs[b] = (
                torch.zeros((b, self.engine.cfg.padded_vocab), dtype=torch.float32, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev))
        return self.outputs[b]

    def _cache(self, b: int, capacity: int) -> Dict[str, Any]:
        if (b, capacity) not in self.caches:
            self.caches[(b, capacity)] = stack_lane_caches(self.engine.cfg, b, capacity,
                                                           self.engine.device)
        return self.caches[(b, capacity)]

    def _capture_prefill(self, params: Any, li, prompt: _Input, capacity: int) -> Any:
        cfg, b = self.engine.cfg, prompt.dev.shape[0]
        cache = self._cache(b, capacity)
        leaves = list(flatten_params(cache).values())
        logits_out, greedy = self._outputs(b)

        def step():
            for t in leaves:
                t.zero_()
            logits, _ = prefill_step(params, cfg, prompt.dev, cache, license_intervals=li)
            logits_out.copy_(logits)
            greedy.copy_(torch.argmax(logits, -1))

        try:
            self.backend.warmup(step)
            graph = self.backend.capture(step)
        except BaseException:
            for t in leaves:             # no half-filled cache: the pristine state
                t.zero_()
            raise
        self.captures += 1
        return graph

    def _capture_decode(self, params: Any, li, toks: _Input, poss: _Input,
                        capacity: int) -> Any:
        cfg, b = self.engine.cfg, toks.dev.shape[0]
        cache = self._cache(b, capacity)
        leaves = list(flatten_params(cache).values())
        logits_out, greedy = self._outputs(b)

        def step():
            logits, _ = serve_step(params, cfg, toks.dev, cache, poss.dev, li)
            logits_out.copy_(logits)
            greedy.copy_(torch.argmax(logits, -1))

        saved = [t.clone() for t in leaves]
        try:
            self.backend.warmup(step)
            graph = self.backend.capture(step)
        finally:
            # the warm-up advanced the cache (its len, any recurrent
            # state): the replay runs this step again
            for t, s in zip(leaves, saved):
                t.copy_(s)
        self.captures += 1
        return graph
