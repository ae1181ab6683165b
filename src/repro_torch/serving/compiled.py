"""The compiled steps of the port: CUDA graphs of the kernel-resident
paged decode and of the chunked prefill.  The decode step runs through
the paged kernels (``slot.decode_kernels``) or, over an int8 KV cache,
through the plain gather, which the kernels cannot read.

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
* **Static inputs**, refilled before every replay by ``copy_`` from
  pinned host buffers: tokens (B, 1) int32, positions (B,) int32, lane
  ids (B,) int64, one (B, T) int32 table per width.  Static outputs, one
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

The backend is a constructor parameter: ``CudaGraphBackend`` on the
card; the CPU tests pass one whose replay re-runs the captured function.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serving.engine import prefill_chunk_step, serve_step_paged


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
    the same weights."""

    def __init__(self, params: Any):
        super().__init__()
        self.params = params
        self.prefill: Dict[Tuple[int, int], Any] = {}


class View(tuple):
    """A licensed view ``(params, intervals)``, as ``TierViewCache`` holds
    it, with the :class:`GraphSet` of the decode steps captured on it and
    its prefill chunks (``prefill_graphs``)."""

    def __new__(cls, params: Any, intervals: Any, graphs: GraphSet):
        view = super().__new__(cls, (params, intervals))
        view.graphs = graphs
        view.prefill_graphs = graphs.prefill
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
    """A static device input and the host buffer it is refilled from
    (pinned on the card)."""

    def __init__(self, shape, dtype, device: torch.device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self.host = torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")

    def fill(self, values) -> None:
        """Refill the leading ``len(values)`` rows (all of them for the
        decode step; a prefill chunk's ``b`` lanes)."""
        n = len(values)
        self.host.numpy()[:n] = values
        self.dev[:n].copy_(self.host[:n], non_blocking=True)


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
        if not self.in_scan:
            return
        if intervals is None:
            self.intervals.zero_()
        else:
            self.intervals[0].copy_(intervals[0])
            self.intervals[1].copy_(intervals[1])

    def _static_intervals(self):
        return (self.intervals[0], self.intervals[1]) if self.in_scan else None


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

        state = _snapshot(pool)
        try:
            self.backend.warmup(step)
            graph = self.backend.capture(step)
        finally:
            _restore(pool, state)
        self.captures += 1
        return graph


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

        # the warm-up is this chunk: its K/V writes and lane state stand
        # (a replay would write the same again); a failed capture puts the
        # lanes' state back
        state = _snapshot(pool)
        try:
            self.backend.warmup(chunk)
            graph = self.backend.capture(chunk)
        except BaseException:
            _restore(pool, state)
            raise
        self.captures += 1
        return graph
