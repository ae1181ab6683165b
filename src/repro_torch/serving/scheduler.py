"""Continuous-batching scheduler of the port: pure host bookkeeping, and
the contiguous cache pool.

Counterpart of ``repro/serving/scheduler.py``.  Every scheduler step
emits one micro-batch that shares a **(license tier, weight version)**
key, because the batch is served through one licensed weight view
(§3.5):

* ``GatewayRequest`` — one generation with its pinned (tier, version),
  lane, block table and timestamps;
* ``TierViewCache`` — LRU cache of licensed weight views keyed by
  (tier, version), so a view is built once per key, not per request;
* ``CachePool`` — the contiguous fallback pool (``paged=False``): one
  ``capacity``-token lane per ``max_batch`` slot plus a scratch lane;
* ``Scheduler`` — admission queue plus the policy.  Admission serves the
  (tier, version) group whose oldest member has waited longest, within
  the free lanes and the block budget (free blocks above the watermark
  plus the prefix cache's reclaimable ones, capped by the fleet's global
  budget), and decode round-robins over the running groups.  Under
  left-aligned *chunked* prefill (the gateway's default) prefill chunks
  and decode steps strictly alternate, so no decode waits longer than
  one chunk; under the bucket prefill (``chunk_size=0``) a waiting
  prefill always goes first, each admission budgets ``prefill_blocks``
  a request, and with the prefix cache admission groups requests by
  their uncached suffix width (``suffix_bucket``).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.models.model import init_cache
from repro_torch.serving.paging import batch_axes


class RequestState(str, Enum):
    QUEUED = "queued"          # admitted, waiting for a free lane
    PREFILLING = "prefilling"  # holds a lane, prompt chunking through
    RUNNING = "running"        # prefilled, holds a lane, decoding
    DONE = "done"              # produced max_new_tokens
    REJECTED = "rejected"      # failed admission (unknown tier / bad prompt)


@dataclass(eq=False)   # identity equality: requests live in queues
class GatewayRequest:
    """One generation request flowing through the gateway; ``version`` is
    pinned at admission, so a request is never re-masked mid-generation."""

    prompt: np.ndarray                       # (S,) int32
    max_new_tokens: int = 16
    license: str = "full"
    temperature: float = 0.0
    top_k: int = 0                           # 0 = no top-k truncation
    seed: int = 0
    # fleet serving (serving/fleet.py): the model slot the request was
    # submitted to, and the tenant it is billed against (recorded in the
    # trace and in ``metrics()["tenants"]``; only a ``FleetGateway``
    # polices it)
    model: Optional[str] = None
    tenant: Optional[str] = None

    # assigned by the gateway
    rid: int = -1
    version: Optional[int] = None
    state: RequestState = RequestState.QUEUED
    out_tokens: List[int] = field(default_factory=list)
    lane: Optional[int] = None               # cache-pool lane while running
    blocks: List[int] = field(default_factory=list)  # paged-pool block table
    cursor: int = 0                          # prompt tokens already prefilled
    prefix_tokens: int = 0                   # prompt tokens served from the
                                             # prefix cache (skipped at prefill)
    pos: int = 0                             # next decode position
    start_seq: int = -1                      # admission order (preemption age)
    preemptions: int = 0
    error: Optional[str] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    # telemetry bookkeeping (serving/telemetry.py).  ``_ttft_done``
    # survives preemption — a restarted request re-emits its first token
    # but its TTFT was already counted once; ``_last_tok_t`` does not
    # (the inter-token gap across a preemption is not a decode gap).
    _ttft_done: bool = False
    _last_tok_t: Optional[float] = None
    _open_span: Optional[str] = None         # current lifecycle B span

    @property
    def group_key(self) -> Tuple[str, Optional[int]]:
        return (self.license, self.version)

    @property
    def latency(self) -> Optional[float]:
        """Submit -> last token wall time (None until DONE)."""
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


@dataclass
class ScheduledAction:
    """One micro-batch decision: prefill or decode a tier-homogeneous
    group.  ``model`` is the serving slot's model name: under a
    ``FleetGateway`` every action is keyed (model, tier, version)."""

    kind: str                                # "prefill" | "decode"
    tier: str
    version: Optional[int]
    requests: List[GatewayRequest]
    # bucket prefill with the prefix cache: the uncached suffix width the
    # whole micro-batch shares (None elsewhere)
    suffix_bucket: Optional[int] = None
    model: Optional[str] = None


class TierViewCache:
    """LRU cache of licensed weight views keyed by (tier, version).

    ``build(tier_name, version)`` materializes a view on miss
    (``apply_license`` for float weights, the fused masked-dequant for
    the int8 store); hit/miss/eviction/invalidation counters feed
    ``stats``.  A staged weight update drops a version's or a redefined
    tier's entries with :meth:`invalidate`."""

    def __init__(self, build: Callable[[str, Optional[int]], Any],
                 capacity: int = 8):
        self._build = build
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Tuple[str, Optional[int]], Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, tier: str, version: Optional[int] = None) -> Any:
        key = (tier, version)
        if key in self._entries:
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        view = self._build(tier, version)
        self._entries[key] = view
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return view

    def __contains__(self, key: Tuple[str, Optional[int]]) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def invalidate(self, *, tier: Optional[str] = None,
                   version: Optional[int] = None) -> int:
        """Drop entries matching the given tier and/or version (None = any)."""
        doomed = [k for k in self._entries
                  if (tier is None or k[0] == tier)
                  and (version is None or k[1] == version)]
        for k in doomed:
            del self._entries[k]
        self.invalidations += len(doomed)
        return len(doomed)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "entries": len(self._entries)}


class CachePool:
    """Contiguous cache pool: ``num_lanes`` per-request cache slots of
    ``capacity`` tokens (the ``paged=False`` fallback, and the pool of a
    model with nothing to page).

    ``leaves`` are the model's own cache (``init_cache``) by path, with
    the lane as its batch axis (``batch_axes``): GQA ``units/b0/k``
    (U, num_lanes + 1, capacity, KH, hd), ``units/b0/len`` (U,
    num_lanes + 1), Mamba-2 ``units/b0/state`` (U, num_lanes + 1, H, N,
    P), a tail block's ``tail/t0/state`` (num_lanes + 1, W), ...  One
    extra *scratch* lane (index ``num_lanes``) absorbs the writes of
    padding lanes, so scatters with duplicate pad indices can never
    corrupt a live request.  A scatter overwrites every leaf of its
    lanes, so a lane taken by a new request after a bucket prefill from
    zeros carries nothing of its previous occupant."""

    def __init__(self, cfg, num_lanes: int, capacity: int, *, device="cuda"):
        self.num_lanes = int(num_lanes)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.leaves: Dict[str, torch.Tensor] = flatten_params(init_cache(
            cfg, self.num_lanes + 1, self.capacity, device=self.device))
        self._axis = batch_axes(cfg, self.capacity)

    @property
    def scratch(self) -> int:
        return self.num_lanes

    @property
    def cache_tokens(self) -> int:
        """Token capacity reserved across lanes (excludes the scratch lane)."""
        return self.num_lanes * self.capacity

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves.values())

    def stats(self) -> Dict[str, int]:
        """Occupancy facts.  Shares only the ``cache_tokens``/``num_lanes``
        core with ``PagedCachePool.stats``: pool-agnostic callers key off
        ``metrics()['cache_pool']['paged']`` before reading block keys."""
        return {"cache_tokens": self.cache_tokens,
                "num_lanes": self.num_lanes, "capacity": self.capacity}

    def pad_lanes(self, lanes: List[int], width: int) -> List[int]:
        """Pad a lane-id list to ``width`` with the scratch lane."""
        lanes = list(lanes)
        assert len(lanes) <= width, (len(lanes), width)
        return lanes + [self.scratch] * (width - len(lanes))

    def _index(self, lanes) -> torch.Tensor:
        return torch.as_tensor(np.asarray(lanes, np.int64)).to(self.device)

    def gather(self, lanes) -> Dict[str, Any]:
        """The lanes' caches as one batch (copies)."""
        idx = self._index(lanes)
        return unflatten({path: t.index_select(self._axis[path], idx)
                          for path, t in self.leaves.items()})

    def scatter(self, lanes, caches: Dict[str, Any]) -> None:
        """Write a batch of lane caches back by lane id."""
        idx = self._index(lanes)
        for path, c in flatten_params(caches).items():
            t = self.leaves[path]
            t.index_copy_(self._axis[path], idx, c.to(t.dtype))


class Scheduler:
    """Continuous-batching policy with block-aware admission.

    * admission serves the waiting (tier, version) group whose oldest
      member arrived first, then every same-key request in queue order,
      up to the free lanes, ``max_batch`` and, with a block allocator,
      the block budget: the free blocks above ``watermark_blocks`` plus
      the prefix cache's ``reclaimable`` ones, which allocation evicts on
      demand, capped by ``global_budget`` under a fleet.  The chunked
      policy charges ``blocks_needed`` per request, the bucket prefill
      ``prefill_blocks`` (its flat worst case) per lane;
    * ``chunked=True``: admitted requests enter PREFILLING and advance
      one chunk per prefill action, strictly alternating with decode
      steps (continuing PREFILLING requests first, then admissions);
      ``chunked=False``: a waiting admission always goes first, and with
      ``suffix_bucket`` (the prefix cache's probe of a request's uncached
      suffix width) a batch holds one bucket only, each member
      re-validated by ``suffix_revalidate`` at formation;
    * decode round-robins over the running groups, rotating within a
      group larger than ``max_batch``;
    * :meth:`preempt` returns a running request to the queue head (it
      keeps its ``submit_t``, so aging re-admits it first).
    """

    def __init__(self, num_lanes: int, max_batch: int, *, allocator: Any = None,
                 prefill_blocks: int = 0, watermark_blocks: int = 0,
                 reclaimable: Optional[Callable[[], int]] = None,
                 suffix_bucket: Optional[Callable[[GatewayRequest], int]] = None,
                 suffix_revalidate: Optional[Callable[[GatewayRequest], int]] = None,
                 chunked: bool = False,
                 blocks_needed: Optional[Callable[[GatewayRequest], int]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.num_lanes = int(num_lanes)
        self.max_batch = int(max_batch)
        self.clock = clock
        self.allocator = allocator
        self.prefill_blocks = int(prefill_blocks)
        self.watermark_blocks = int(watermark_blocks)
        self.reclaimable = reclaimable
        self.suffix_bucket = suffix_bucket
        self.suffix_revalidate = suffix_revalidate
        self.chunked = bool(chunked)
        self.blocks_needed = blocks_needed
        # fleet hooks, wired after construction by FleetGateway
        # (serving/fleet.py).  ``global_budget`` returns how many MORE of
        # this slot's blocks the fleet-wide cache budget can cover
        # (counting every slot's reclaimable chains); admission takes the
        # min of the local and global budgets.  ``admission_filter``
        # re-validates a QUEUED request at batch formation (tenant
        # entitlement revoked since submit); returning False drops it
        # from the queue — the callback itself marks it rejected.
        self.global_budget: Optional[Callable[[], int]] = None
        self.admission_filter: Optional[Callable[[GatewayRequest], bool]] = None
        self.waiting: Deque[GatewayRequest] = deque()
        self.running: List[GatewayRequest] = []
        self._free_lanes: List[int] = list(range(num_lanes))
        self._rr = 0
        self._chunk_rr = 0
        self._group_cursor: Dict[Hashable, int] = {}
        self._start_seq = 0
        self._last_prefill = False

    # ----------------------------------------------------------- bookkeeping
    def submit(self, req: GatewayRequest) -> None:
        req.state = RequestState.QUEUED
        self.waiting.append(req)

    def start(self, req: GatewayRequest, *, prefilling: bool = False) -> int:
        """Move a request to RUNNING (or PREFILLING, when its prompt will
        chunk through over several steps), assigning it a lane."""
        lane = self._free_lanes.pop()
        req.lane = lane
        req.state = RequestState.PREFILLING if prefilling else RequestState.RUNNING
        req.start_seq = self._start_seq
        self._start_seq += 1
        self.running.append(req)
        return lane

    def finish(self, req: GatewayRequest) -> None:
        """Release the lane of a completed request."""
        self.running.remove(req)
        if req.lane is not None:
            self._free_lanes.append(req.lane)
        req.lane = None
        req.state = RequestState.DONE
        req.finish_t = self.clock()

    def preempt(self, req: GatewayRequest) -> None:
        """Evict a running request back to the head of the queue; it
        restarts from scratch on re-admission (recompute preemption —
        generation is deterministic given (seed, prompt, view)).  The
        caller releases its cache blocks."""
        self.running.remove(req)
        if req.lane is not None:
            self._free_lanes.append(req.lane)
        req.lane = None
        req.pos = 0
        req.cursor = 0
        req.prefix_tokens = 0
        req.out_tokens.clear()
        req.first_token_t = None
        req._last_tok_t = None
        req.preemptions += 1
        req.state = RequestState.QUEUED
        self.waiting.appendleft(req)

    def youngest_running(self) -> Optional[GatewayRequest]:
        """Most recently started request — the preemption victim."""
        if not self.running:
            return None
        return max(self.running, key=lambda r: r.start_seq)

    def pinned_versions(self) -> set:
        """Weight versions still referenced by queued or running requests."""
        return {r.version for r in self.waiting} | {r.version for r in self.running}

    def pinned_tier_versions(self) -> set:
        """(tier, version) pairs referenced by queued or running requests."""
        return {(r.license, r.version)
                for r in list(self.waiting) + list(self.running)}

    def hot_tiers(self) -> List[str]:
        """License tiers with queued or running requests, busiest first —
        the tiers the staged update prewarms at the new version."""
        counts: Dict[str, int] = {}
        for r in list(self.running) + list(self.waiting):
            counts[r.license] = counts.get(r.license, 0) + 1
        return sorted(counts, key=lambda t: (-counts[t], t))

    # --------------------------------------------------------- wait metrics
    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest queued request (0.0 with an empty queue)."""
        if not self.waiting:
            return 0.0
        now = self.clock() if now is None else now
        return now - min(r.submit_t for r in self.waiting)

    def queue_wait_by_tier(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-tier age of the oldest queued request."""
        now = self.clock() if now is None else now
        out: Dict[str, float] = {}
        for r in self.waiting:
            out[r.license] = max(out.get(r.license, 0.0), now - r.submit_t)
        return out

    # ---------------------------------------------------------------- policy
    def _budget(self) -> int:
        """Blocks admission may take: free above the watermark, plus the
        prefix cache's reclaimable ones, capped by the fleet's budget."""
        budget = self.allocator.num_free - self.watermark_blocks
        if self.reclaimable is not None:
            budget += self.reclaimable()
        if self.global_budget is not None:
            budget = min(budget, self.global_budget())
        return budget

    def _prefill_room(self) -> int:
        room = min(len(self._free_lanes), self.max_batch)
        if self.allocator is not None and self.prefill_blocks > 0:
            room = min(room, max(0, self._budget() // self.prefill_blocks))
        return room

    def next_action(self) -> Optional[ScheduledAction]:
        if not self.chunked:
            act = self._admission_batch()
            return act if act is not None else self._decode_action()
        chunking = [r for r in self.running
                    if r.state is RequestState.PREFILLING]
        decoding = [r for r in self.running
                    if r.state is RequestState.RUNNING]
        if self._last_prefill and decoding:
            self._last_prefill = False
            return self._decode_action()
        act = (self._chunk_action(chunking) if chunking
               else self._admission_batch())
        if act is not None:
            self._last_prefill = True
            return act
        if decoding:
            self._last_prefill = False
            return self._decode_action()
        return None

    def _rotate(self, groups: Dict[Hashable, List[GatewayRequest]],
                rr: int, tag: str) -> Tuple[Hashable, List[GatewayRequest]]:
        """Pick group ``rr`` (sorted keys) and at most ``max_batch`` of its
        members, rotating within a group larger than that."""
        keys = sorted(groups, key=str)
        key = keys[rr % len(keys)]
        members = groups[key]
        if len(members) > self.max_batch:
            cur = self._group_cursor.get((tag, key), 0) % len(members)
            members = (members + members)[cur:cur + self.max_batch]
            self._group_cursor[(tag, key)] = cur + self.max_batch
        return key, list(members)

    def _chunk_action(self, chunking: List[GatewayRequest]) -> ScheduledAction:
        """Continue mid-prefill requests, round-robin over their groups."""
        groups: Dict[Hashable, List[GatewayRequest]] = {}
        for r in chunking:
            groups.setdefault(r.group_key, []).append(r)
        key, members = self._rotate(groups, self._chunk_rr, "chunk")
        self._chunk_rr += 1
        return ScheduledAction("prefill", key[0], key[1], members)

    def _admission_batch(self) -> Optional[ScheduledAction]:
        if self.admission_filter is not None and self.waiting:
            # entitlement re-check at batch formation: a tenant revoked
            # since submit must not reach a lane.  In-flight requests are
            # never revisited: a revocation drains, it never cancels.
            self.waiting = deque(r for r in self.waiting if self.admission_filter(r))
        room = self._prefill_room()
        if not (room and self.waiting):
            return None
        # aging: serve the group whose oldest member arrived first;
        # deque position breaks ties (plain FIFO when ages are equal)
        oldest: Dict[Tuple, Tuple[float, int]] = {}
        for i, r in enumerate(self.waiting):
            cand = (r.submit_t, i)
            if r.group_key not in oldest or cand < oldest[r.group_key]:
                oldest[r.group_key] = cand
        key = min(oldest, key=lambda k: oldest[k])
        bucket: Optional[int] = None
        anchor: Optional[GatewayRequest] = None
        probed: Dict[int, int] = {}          # id(req) -> bucket, one probe a pass

        def _bucket(r: GatewayRequest) -> int:
            got = probed.get(id(r))
            if got is None:
                got = probed[id(r)] = self.suffix_bucket(r)
            return got

        if self.suffix_bucket is not None:
            # the oldest member defines the batch's suffix width; same-key
            # requests in another bucket wait for their own batch.  The
            # anchor's probe is fresh when a revalidator is wired: a stale
            # cached bucket must not define the batch.
            anchor = self.waiting[oldest[key][1]]
            if self.suffix_revalidate is not None:
                bucket = probed[id(anchor)] = self.suffix_revalidate(anchor)
            else:
                bucket = _bucket(anchor)
        budget: Optional[int] = None
        if self.allocator is not None and self.blocks_needed is not None:
            budget = self._budget()
        batch: List[GatewayRequest] = []
        remaining: Deque[GatewayRequest] = deque()
        for r in self.waiting:               # one pass: select + requeue
            take = (len(batch) < room and r.group_key == key
                    and (bucket is None or _bucket(r) == bucket))
            if (take and bucket is not None and r is not anchor
                    and self.suffix_revalidate is not None):
                # the cached probe may predate an eviction that shrank
                # this request's cached prefix
                fresh = probed[id(r)] = self.suffix_revalidate(r)
                take = fresh == bucket
            if take and budget is not None:
                need = self.blocks_needed(r)
                take = need <= budget
                if take:
                    budget -= need
            (batch if take else remaining).append(r)
        self.waiting = remaining
        if not batch:
            return None
        return ScheduledAction("prefill", key[0], key[1], batch, suffix_bucket=bucket)

    def _decode_action(self) -> Optional[ScheduledAction]:
        pool = [r for r in self.running if r.state is RequestState.RUNNING]
        if not pool:
            return None
        groups: Dict[Hashable, List[GatewayRequest]] = {}
        for r in pool:
            groups.setdefault(r.group_key, []).append(r)
        key, members = self._rotate(groups, self._rr, "decode")
        self._rr += 1
        return ScheduledAction("decode", key[0], key[1], members)
