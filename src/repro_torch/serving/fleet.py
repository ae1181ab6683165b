"""Multi-model, multi-tenant fleet serving of the port.

Counterpart of ``repro/serving/fleet.py``: one serving loop hosting
several licensed models at once, each with its own licensing ladder,
sharing device cache memory under one global budget, with per-tenant
entitlements and quotas enforced at the door.  Three layers:

* :class:`ModelSlot` — everything one served model owns: the weight
  versions, the (tier, version)-keyed view cache, the block-paged KV
  pool, the shared-prefix radix cache over it, the chunked-prefill
  scheduler, the compiled decode and chunked-prefill steps (CUDA graphs
  on the card, ``serving/compiled.py``), the serving stats, the observability
  substrate (a ``Telemetry`` registry with the slot's instruments, a
  ``TraceRecorder`` event tape and an ``AuditLog``, all on the slot's
  clock), the opt-in sanitizer, and the license-server state of the
  update path (transport, retry policy, the license lease, sync
  failures and version quarantine, tiers learned from the server,
  pending tier changes, the active staged sync).  ``LicensedGateway``
  (``gateway.py``) wraps one slot and forwards attribute access to it.
* :class:`TenantRegistry` — per-tenant (model, tier) entitlements,
  concurrent-request quotas and token-bucket rate limits, checked at
  ``submit`` (entitlement + concurrency + rate) and again at batch
  formation (entitlement only: a tenant revoked while its request
  queued must not reach a lane; a request already decoding completes).
* :class:`FleetGateway` — N slots behind one submit/step/run loop.  Each
  iteration runs ONE slot's micro-batch (round-robin over slots with
  work) and advances at most ONE slot's active update stager.

The license lease: grants are fresh for ``lease_ttl_s`` after the last
good server exchange; past that the slot serves DEGRADED (granted tiers
only, no new server grants) until ``lease_grace_s`` runs out, then
OFFLINE applies ``lease_policy`` at admission (``reject``, or ``floor``:
serve ``lease_floor_tier`` instead).  A rate-limited
``production_version`` probe brings an idle slot back to HEALTHY.

Global cache budget: denominated in bytes (``PagedCachePool.block_bytes``
is each slot's exchange rate).  Admission takes ``min(local budget,
global headroom)``; retained prefix chains anywhere in the fleet count as
headroom, and allocation evicts them (the requesting slot's own first,
then the others', LRU within each, always through the owning slot's
``PrefixCache``) before giving up.  Decode growth that still finds no
headroom preempts within its own slot, never across slots.  The budget
reads host counters only: no device access on admission.

Every constructor argument of the JAX slot is recognised.  Those whose
features are not ported accept the values the port implements (the JAX
default among them where the port behaves as the JAX slot does at that
default); anything else raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it — never accepted and then ignored.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sanitize import ServingSanitizer, sanitize_from_env
from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import FULL_TIER, LicenseTier, apply_license
from repro_torch.core.transport import (DirectTransport, RetryPolicy, Transport,
                                        TransportDisconnect, TransportError,
                                        TransportTimeout)
from repro_torch.models.model import check_supported
from repro_torch.serving.paging import NoPagedLeavesError, PagedCachePool, cdiv
from repro_torch.serving.compiled import (DecodeGraphs, GraphSet, PrefillGraphs, StoreGraphs,
                                          View)
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.engine import right_align
from repro_torch.serving.scheduler import (CachePool, GatewayRequest, RequestState,
                                           Scheduler, TierViewCache)
from repro_torch.serving.telemetry import (FLEET_METRICS_KEYS, GATEWAY_METRICS_KEYS,
                                           Telemetry)
from repro_torch.serving.tracing import AuditLog, TraceRecorder, merge_chrome_traces

# argument -> (the values the port implements, ROADMAP.md item for the rest)
_LEFT_OUT: Dict[str, Tuple[Tuple[Any, ...], str]] = {
    # the port samples on the device inside every step and keeps no logits
    "fuse_sampling": ((True,), "the rest of the package"),
    "record_logits": ((False,), "the rest of the package"),
}


def _check_left_out(kw: Dict[str, Any]) -> None:
    for name, value in kw.items():
        if name not in _LEFT_OUT:
            raise TypeError(f"unexpected argument {name!r}")
        ported, item = _LEFT_OUT[name]
        if value not in ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; see ROADMAP.md, {item!r}")


def _decode_kernels_arg(decode_kernels: Optional[bool],
                        decode_pallas: Optional[str]) -> Optional[bool]:
    """``decode_kernels`` with ``decode_pallas``, the JAX slot's name for
    the switch, folded in: ``"pallas"`` is True (the Hopper kernels),
    ``"off"`` False (the plain path), None keeps ``decode_kernels``."""
    if decode_pallas == "interpret":
        raise ValueError("decode_pallas='interpret': the port has no interpret mode; "
                         "its kernels run on a CUDA device ('pallas') and its plain "
                         "path anywhere ('off')")
    if decode_pallas not in (None, "off", "pallas"):
        raise ValueError(f"decode_pallas={decode_pallas!r} not in "
                         f"('off', 'pallas', 'interpret')")
    if decode_pallas is None:
        return decode_kernels
    want = decode_pallas == "pallas"
    if decode_kernels is not None and bool(decode_kernels) != want:
        raise ValueError(f"decode_pallas={decode_pallas!r} contradicts "
                         f"decode_kernels={decode_kernels!r}")
    return want


class ModelSlot:
    """Per-model serving state: one config's pool + views + scheduler.
    Parameters are documented on ``LicensedGateway``."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        tiers: Optional[Dict[str, LicenseTier]] = None,
        quantized: bool = False,
        already_quantized: bool = False,
        materialize_int8_views: bool = False,
        max_batch: int = 8,
        max_prompt: int = 32,
        max_new_cap: int = 64,
        paged: bool = True,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_lanes: Optional[int] = None,
        watermark_blocks: int = 0,
        prefix_cache: bool = True,
        chunk_size: Optional[int] = None,
        kernel_decode: Optional[bool] = None,
        decode_pallas: Optional[str] = None,
        decode_kernels: Optional[bool] = None,
        view_capacity: int = 8,
        version: int = 1,
        server: Any = None,
        model: str = "model",
        clock: Optional[Callable[[], float]] = None,
        transport: Optional[Transport] = None,
        retry_policy: Optional[RetryPolicy] = None,
        lease_ttl_s: float = 60.0,
        lease_grace_s: float = 300.0,
        lease_policy: str = "reject",
        lease_floor_tier: Optional[str] = None,
        quarantine_after: int = 3,
        history: int = 10_000,
        telemetry: Any = True,
        sanitize: Optional[bool] = None,
        device="cuda",
        **left_out: Any,
    ):
        _check_left_out(left_out)
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['tok'].device}, "
                             f"the gateway on {self.device}")
        self.clock = clock if clock is not None else time.perf_counter
        # observability substrate first: every layer below records
        # through these.  ``telemetry`` accepts True (own registry),
        # False (everything off) or a shared Telemetry.
        if isinstance(telemetry, Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = Telemetry(clock=self.clock, enabled=bool(telemetry))
        self.obs = self.telemetry.enabled
        self.tracer = TraceRecorder(clock=self.clock, enabled=self.obs)
        self.audit = AuditLog(clock=self.clock, enabled=self.obs)
        self.quantized = bool(quantized or already_quantized)
        self.materialize_int8_views = bool(materialize_int8_views)
        if self.quantized and not already_quantized:
            from repro_torch.serving.quantized import quantize_serving_params

            params = quantize_serving_params(params)
        self.max_batch = int(max_batch)
        self.max_prompt = int(max_prompt)
        self.max_new_cap = int(max_new_cap)
        self.capacity = self.max_prompt + self.max_new_cap

        self.version = int(version)
        self._weights: Dict[int, Any] = {self.version: params}
        self.tiers: Dict[str, LicenseTier] = dict(tiers or {})
        self.tiers.setdefault("full", FULL_TIER)
        self.views = TierViewCache(self._materialize, capacity=view_capacity)
        self._store_graphs = StoreGraphs()   # the in-scan path's, per version

        decode_kernels = _decode_kernels_arg(decode_kernels, decode_pallas)
        self.paged = bool(paged)
        if self.paged:
            self.max_lanes = int(max_lanes or self.max_batch)
            bpl = cdiv(self.capacity, int(block_size))
            try:
                self.pool = PagedCachePool(
                    cfg, self.max_lanes, self.capacity, int(block_size),
                    int(num_blocks) if num_blocks is not None else self.max_lanes * bpl,
                    device=self.device)
            except NoPagedLeavesError:
                # nothing per-token to page (attention-free, or a sliding
                # window below the capacity caps every attention cache):
                # the lane state is constant-size, so the contiguous pool
                self.paged = False
        # kernel-resident decode needs every attention cache paged and
        # addressable by block: a sliding window's ring is not, so window
        # models keep the gather/scatter decode (asked for or not)
        supported = self.paged and cfg.window == 0
        self.kernel_decode = (supported if kernel_decode is None
                              else bool(kernel_decode) and supported)
        # the kernels serve the kernel-resident step only, on a CUDA
        # device, where they are the default; the gather/scatter decode
        # and the CPU take the plain path.  They read float K/V: an int8
        # cache takes the plain gather, as the JAX slot's paged block
        # does whatever is asked, decided here once
        on_cuda = self.device.type == "cuda"
        if decode_kernels is None:
            decode_kernels = on_cuda and self.kernel_decode and not cfg.kv_cache_int8
        elif decode_kernels and not self.kernel_decode:
            raise ValueError("decode_kernels=True needs the kernel-resident decode "
                             "(paged=True, kernel_decode not False, no sliding window): "
                             "the gather/scatter decode has no kernels")
        elif decode_kernels and cfg.kv_cache_int8:
            raise ValueError("decode_kernels=True needs a float KV cache: the paged "
                             "kernels read float K/V, and kv_cache_int8 keeps int8 codes")
        elif decode_kernels and not on_cuda:
            raise ValueError(f"decode_kernels=True needs a CUDA device, got "
                             f"{self.device}")
        self.decode_kernels = bool(decode_kernels)
        # the compiled steps (CUDA graphs) take the kernel-resident decode
        # on the card: through the kernels, or the int8 cache's plain gather
        compiled = on_cuda and self.kernel_decode and (self.decode_kernels
                                                       or cfg.kv_cache_int8)
        if self.paged:
            self._prefill_blocks = max(1, cdiv(self.max_prompt, self.pool.block_size))
            if self.pool.num_blocks - int(watermark_blocks) < self._prefill_blocks:
                raise ValueError(
                    f"watermark_blocks={watermark_blocks} leaves no room to "
                    f"admit a prefill ({self._prefill_blocks} blocks of "
                    f"{self.pool.num_blocks}) — the gateway would accept "
                    f"requests and never schedule them")
            # prefix reuse and chunked prefill both need every per-lane
            # leaf to be a reconstructible position counter: recurrent or
            # ring lane state opts the model out of both
            chunk_ok = self.pool.prefix_cacheable
            self.prefix = (PrefixCache(self.pool.allocator, self.pool.block_size)
                           if prefix_cache and chunk_ok else None)
            # left-aligned chunked prefill, one block per chunk by default
            # (the JAX gateway's); 0 is the bucket prefill
            if chunk_size is None:
                self.chunk_size = self.pool.block_size if chunk_ok else 0
            else:
                self.chunk_size = int(chunk_size)
                if self.chunk_size > 0 and not chunk_ok:
                    raise ValueError(
                        "chunked prefill needs reconstructible per-lane "
                        "cache state (the prefix_cache condition); this "
                        "model keeps ring/SSM lane state — pass "
                        "chunk_size=0 or leave it None")
            if self.chunk_size > 0:
                self.chunk_size = min(self.chunk_size, self.max_prompt)
            self.chunked = self.chunk_size > 0
            bucketed = self.prefix is not None and not self.chunked
            self.scheduler = Scheduler(
                self.max_lanes, self.max_batch, allocator=self.pool.allocator,
                prefill_blocks=0 if self.chunked else self._prefill_blocks,
                watermark_blocks=int(watermark_blocks),
                reclaimable=(self.prefix.reclaimable
                             if self.prefix is not None else None),
                suffix_bucket=self._suffix_bucket if bucketed else None,
                suffix_revalidate=self._suffix_bucket_fresh if bucketed else None,
                chunked=self.chunked,
                blocks_needed=self._blocks_needed if self.chunked else None,
                clock=self.clock)
            self._zero_cap = self.pool.padded_capacity
        else:
            if chunk_size:
                raise ValueError("chunked prefill requires the paged pool")
            self.chunk_size = 0
            self.chunked = False
            self.max_lanes = self.max_batch
            self.pool = CachePool(cfg, self.max_batch, self.capacity, device=self.device)
            self.scheduler = Scheduler(self.max_batch, self.max_batch, clock=self.clock)
            self.prefix = None
            self._zero_cap = self.capacity

        # opt-in runtime sanitizers: shadow block lifecycle + step-shape
        # sentinel.  Attached HERE, before any block traffic (the prefix
        # cache and the scheduler reach the allocator through the object,
        # so the wrap on the instance covers them), so the shadow sees
        # every allocation.
        if sanitize is None:
            sanitize = sanitize_from_env()
        self.sanitizer = ServingSanitizer() if sanitize else None
        if self.sanitizer is not None:
            rt = self.sanitizer.retrace
            # sampling-variant families (greedy, sampling, sampling with
            # top-k): <= 3 keys, bounded at 4 as in the JAX package
            for fam in ("steps", "prefix_prefill", "paged_decode"):
                rt.bound(fam, 4)
            if self.paged:
                self.sanitizer.attach_allocator(self.pool.allocator)
                bpl = self.pool.blocks_per_lane
                # chunked prefill pow2-buckets both axes:
                # b in {1,2,..,max_batch}, cols in {1,2,..,pow2(bpl)}
                rt.bound("prefill_chunk",
                         (self.max_batch.bit_length() + 1) * (bpl.bit_length() + 2))
                # decode tables are trimmed to the batch's exact used width
                # (unbucketed by design): bounded by the lane cap
                rt.bound("decode_width", bpl)

        if transport is not None and server is None:
            server = transport.server
        self._server = server
        # every wire call to the license server goes through the
        # transport seam; a raw server gets the pass-through wrapper
        if transport is not None:
            self._transport: Optional[Transport] = transport
        elif isinstance(server, Transport):
            self._transport = server
            self._server = server.server
        else:
            self._transport = (DirectTransport(server)
                               if server is not None else None)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        # license lease: grants are fresh for ttl after the last
        # successful server exchange; past that the slot serves DEGRADED
        # (pinned views only, no new server grants) until grace runs out,
        # then OFFLINE applies ``lease_policy`` at admission
        if lease_policy not in ("reject", "floor"):
            raise ValueError(f"lease_policy={lease_policy!r} not in "
                             f"('reject', 'floor')")
        self.lease_ttl_s = float(lease_ttl_s)
        self.lease_grace_s = float(lease_grace_s)
        self.lease_policy = lease_policy
        self.lease_floor_tier = lease_floor_tier
        self._lease_state = "healthy"
        self._lease_renewed_t = self.clock()  # guarded-by: owner(__init__, _lease_renew)
        self._lease_degraded_since: Optional[float] = None
        self._degraded_seconds = 0.0
        self._lease_recheck_t: Optional[float] = None
        self._tiers_stale = False     # refresh deferred by a wire fault
        # version quarantine: consecutive failed syncs per target version
        self.quarantine_after = int(quarantine_after)
        self._sync_failures: Dict[int, int] = {}
        self.quarantined_versions: set = set()
        self.model = model
        self._client = None           # EdgeClient when booted from a server
        self._server_tiers: set = set()  # tier names learned from the server
        # tier updates deferred while their requests are in flight;
        # value None = pending revocation
        self._pending_tiers: Dict[str, Optional[LicenseTier]] = {}
        # staged weight sync (serving/updates.py): the active stager (one
        # bounded step interleaved per scheduler step) and the version it
        # is pre-registering weights/views under before the flip
        self._stager = None
        self._staging_version: Optional[int] = None

        # fleet wiring (None when the slot serves standalone): the
        # wrapping gateway, the composing FleetGateway, and the finish
        # hook the fleet uses for tenant accounting
        self.gateway: Any = None
        self.fleet: Any = None
        self.on_finish: Optional[Callable[[GatewayRequest], None]] = None
        self._next_rid = 0
        # bounded: a long-lived gateway must not grow host memory with
        # every request served; metrics percentiles cover this window
        self.completed: "deque[GatewayRequest]" = deque(maxlen=history)
        self.trace: "deque[Tuple[str, str, Optional[int], int]]" = \
            deque(maxlen=history)
        self._drain_sink: Optional[List[GatewayRequest]] = None
        self.stats: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "completed": 0,
            "prefill_batches": 0, "decode_steps": 0,
            "resident_decode_steps": 0, "tokens_generated": 0,
            "preempted": 0, "max_running": 0, "max_blocks_in_use": 0,
            # prefix-cache accounting: lane-tokens actually run through the
            # prefill step, prompt tokens served from retained blocks, and
            # copy-on-write copies
            "prefill_lane_tokens": 0, "prefix_tokens_reused": 0,
            "cow_copies": 0,
            "prefill_chunks": 0,
            # tenant enforcement: requests bounced by entitlement /
            # concurrency / rate-limit checks (submit OR admission)
            "quota_rejections": 0,
            # fault tolerance: wire retries across all sync/tier calls,
            # the subset whose cause was a timeout/disconnect, and
            # versions quarantined after repeated failed syncs
            "sync_retries": 0, "sync_timeouts": 0, "sync_quarantines": 0,
        }
        # bucket prefill with the prefix cache: prefill batches served per
        # suffix-width bucket (the grouping decision, in metrics())
        self.bucket_batches: Dict[int, int] = {}

        # the compiled decode and chunked-prefill steps (serving/
        # compiled.py): CUDA graphs of the kernel path on the card, both
        # in one memory pool; the plain path and the CPU run eagerly.
        # Private: the eager steps stay reachable by setting either to None.
        self._graphs = DecodeGraphs(self) if compiled else None
        self._prefill_graphs = (PrefillGraphs(self, backend=self._graphs.backend)
                                if compiled and self.chunked else None)

        self._register_telemetry()
        # seed the audit ledger: the tiers this slot can serve from birth
        if self.obs:
            for name in self.tiers:
                self.audit.record("tier_grant", model=self.model, tier=name,
                                  version=self.version, source="config")

    # ---------------------------------------------------------- observability
    def _register_telemetry(self) -> None:
        """Register this slot's instruments (all labeled by model name),
        under the JAX package's series names.

        Counters and gauges are *pull*-backed: they read the ``stats``
        dict / scheduler / pool at export time, so the serving hot path
        pays nothing for them.  Only the latency histograms are push
        instruments."""
        t, lb = self.telemetry, {"model": self.model}
        stats = self.stats

        def _stat(key: str):
            return lambda: stats[key]

        for key, name, help_ in (
            ("admitted", "serving_requests_admitted_total",
             "Requests past admission"),
            ("rejected", "serving_requests_rejected_total",
             "Requests bounced at admission"),
            ("completed", "serving_requests_completed_total",
             "Requests that produced max_new_tokens"),
            ("tokens_generated", "serving_tokens_generated_total",
             "Tokens delivered across all requests"),
            ("prefill_batches", "serving_prefill_batches_total",
             "Prefill micro-batches executed"),
            ("prefill_chunks", "serving_prefill_chunks_total",
             "Chunked-prefill actions executed"),
            ("decode_steps", "serving_decode_steps_total",
             "Decode micro-batch steps executed"),
            ("preempted", "serving_preemptions_total",
             "Requests preempted on pool exhaustion"),
            ("quota_rejections", "serving_quota_rejections_total",
             "Tenant quota/rate/entitlement rejections"),
            ("prefix_tokens_reused", "serving_prefix_tokens_reused_total",
             "Prompt tokens served from the prefix cache"),
            ("cow_copies", "serving_cow_copies_total",
             "Copy-on-write block copies before shared-block writes"),
            ("sync_retries", "serving_sync_retries_total",
             "Wire-call retries across sync and tier fetches"),
            ("sync_timeouts", "serving_sync_timeouts_total",
             "Wire-call retries caused by timeouts/disconnects"),
            ("sync_quarantines", "serving_sync_quarantines_total",
             "Versions quarantined after repeated failed syncs"),
        ):
            t.counter(name, labels=lb, help=help_, fn=_stat(key))
        _LEASE_LEVEL = {"healthy": 0, "degraded": 1, "offline": 2}
        t.gauge("serving_license_lease_state", labels=lb,
                help="License lease state (0 healthy, 1 degraded, 2 offline)",
                fn=lambda: _LEASE_LEVEL[self._lease_state])
        t.counter("serving_degraded_seconds_total", labels=lb,
                  help="Cumulative seconds spent outside the healthy "
                       "lease state",
                  fn=self.degraded_seconds_total)
        t.gauge("serving_queue_depth", labels=lb,
                help="Requests waiting for admission",
                fn=lambda: len(self.scheduler.waiting))
        t.gauge("serving_running_requests", labels=lb,
                help="Requests holding a lane (prefilling or decoding)",
                fn=lambda: len(self.scheduler.running))
        t.gauge("serving_oldest_queue_wait_seconds", labels=lb,
                help="Age of the oldest queued request",
                fn=self.scheduler.oldest_wait_s)
        t.gauge("serving_weight_version", labels=lb,
                help="Weight version new admissions pin",
                fn=lambda: self.version)
        t.gauge("serving_view_cache_entries", labels=lb,
                help="Materialized (tier, version) weight views",
                fn=lambda: len(self.views))
        if self.paged:
            t.gauge("serving_cache_blocks_held", labels=lb,
                    help="Physical cache blocks allocated",
                    fn=lambda: self.pool.allocator.num_held)
            t.gauge("serving_cache_blocks_free", labels=lb,
                    help="Physical cache blocks on the free list",
                    fn=lambda: self.pool.allocator.num_free)
        if self.prefix is not None:
            t.gauge("serving_prefix_reclaimable_blocks", labels=lb,
                    help="Retained prefix blocks evictable on demand",
                    fn=self.prefix.reclaimable)
        h = t.histogram
        self.h_ttft = h("serving_ttft_seconds", labels=lb,
                        help="Submit to first token")
        self.h_gap = h("serving_inter_token_seconds", labels=lb,
                       help="Gap between consecutive tokens of one request")
        self.h_queue = h("serving_queue_wait_seconds", labels=lb,
                         help="Submit to lane assignment")
        self.h_prefill = h("serving_prefill_step_seconds", labels=lb,
                           help="Wall time of one prefill action")
        self.h_decode = h("serving_decode_step_seconds", labels=lb,
                          help="Wall time of one decode step")
        self.h_stager = h("serving_stager_step_seconds", labels=lb,
                          help="Wall time of one staged-update step "
                               "(the decode-stall bound)")
        t.declare(*GATEWAY_METRICS_KEYS)

    # ------------------------------------------- license lease & fault handling
    def degraded_seconds_total(self) -> float:
        """Cumulative clock time outside HEALTHY, including the open span."""
        total = self._degraded_seconds
        if self._lease_degraded_since is not None:
            total += self.clock() - self._lease_degraded_since
        return total

    def _lease_renew(self) -> None:
        """Record a successful server exchange.

        Timestamp-only store: safe to call from the background fetch
        worker.  State *transitions* (and their audit/trace events)
        happen lazily in :meth:`_lease_tick` on the serving thread."""
        self._lease_renewed_t = self.clock()

    def _lease_target(self, now: float) -> str:
        age = now - self._lease_renewed_t
        if age <= self.lease_ttl_s:
            return "healthy"
        if age <= self.lease_ttl_s + self.lease_grace_s:
            return "degraded"
        return "offline"

    def _lease_tick(self) -> None:
        """Advance the lease state machine (serving thread only).

        Purely time-driven: the target state is a function of the age of
        the last successful exchange against ttl/grace, so a renewal from
        the fetch worker heals the lease on the next tick.  While
        unhealthy, a rate-limited probe (``production_version``) gives an
        idle gateway (no sync in flight, no tier fetches) a path back to
        HEALTHY."""
        if self._server is None:
            return
        now = self.clock()
        target = self._lease_target(now)
        if target != "healthy":
            # self-heal probe, at most ~4 per ttl so an unreachable
            # server costs bounded wire attempts per serving step
            interval = max(0.05, min(1.0, self.lease_ttl_s / 4))
            if (self._lease_recheck_t is None
                    or now - self._lease_recheck_t >= interval):
                self._lease_recheck_t = now
                try:
                    self._transport.production_version(self.model)
                    self._lease_renew()
                    target = "healthy"
                except (TransportError, KeyError):
                    pass
        if target == self._lease_state:
            return
        prev, self._lease_state = self._lease_state, target
        if prev == "healthy":
            self._lease_degraded_since = now
        elif target == "healthy":
            if self._lease_degraded_since is not None:
                self._degraded_seconds += now - self._lease_degraded_since
            self._lease_degraded_since = None
        event = ("lease_restored" if target == "healthy"
                 else "lease_" + target)
        if self.obs:
            self.audit.record(event, model=self.model, prev=prev,
                              state=target,
                              renew_age_s=round(now - self._lease_renewed_t, 3))
            self.tracer.instant("lease:" + target,
                                attrs={"model": self.model, "prev": prev})
        if target == "healthy" and self._tiers_stale:
            # a tier refresh was deferred by a wire fault mid-sync;
            # rerun it now that the server is reachable again
            owner = self.gateway if self.gateway is not None else self
            refresh = getattr(owner, "_refresh_server_tiers", None)
            if refresh is not None:
                refresh()

    def _lease_admission(self, license: str) -> Tuple[str, Optional[str]]:
        """Admission-time lease gate: ``(serve_as_tier, error)``.

        HEALTHY/DEGRADED serve every already-granted tier unchanged
        (DEGRADED only refuses *new* server grants, in
        :meth:`_resolve_tier`).  OFFLINE applies the configured policy:
        ``floor`` substitutes the floor tier when it is locally known,
        ``reject`` (or a missing floor) bounces the request."""
        self._lease_tick()
        if self._lease_state != "offline":
            return license, None
        if (self.lease_policy == "floor"
                and self.lease_floor_tier is not None
                and self.lease_floor_tier in self.tiers):
            return self.lease_floor_tier, None
        return license, (f"license lease offline (policy="
                         f"{self.lease_policy}): cannot validate tier "
                         f"{license!r} against an unreachable server")

    def _count_wire_retry(self, attempt: int, exc: BaseException,
                          delay: float, to_version: Optional[int] = None,
                          ) -> None:
        """RetryPolicy ``on_retry`` hook: counters + audit per backoff."""
        self.stats["sync_retries"] += 1
        if isinstance(exc, (TransportTimeout, TransportDisconnect)):
            self.stats["sync_timeouts"] += 1
        if self.obs:
            self.audit.record("sync_retry", model=self.model,
                              attempt=attempt, error=type(exc).__name__,
                              backoff_s=round(delay, 4),
                              to_version=to_version)

    def _note_sync_failure(self, version: int) -> None:
        """Count a consecutive failed sync toward quarantining ``version``."""
        n = self._sync_failures.get(version, 0) + 1
        self._sync_failures[version] = n
        if (n >= self.quarantine_after
                and version not in self.quarantined_versions):
            self.quarantined_versions.add(version)
            self.stats["sync_quarantines"] += 1
            if self.obs:
                self.audit.record("sync_quarantine", model=self.model,
                                  version=version, failures=n)
                self.tracer.instant("sync:quarantine",
                                    attrs={"model": self.model,
                                           "version": version})

    def _note_sync_success(self, version: int) -> None:
        self._sync_failures.pop(version, None)
        self._lease_renew()

    def clear_quarantine(self, version: Optional[int] = None) -> None:
        """Operator override: drop the quarantine (one version or all)."""
        if version is None:
            self.quarantined_versions.clear()
            self._sync_failures.clear()
        else:
            self.quarantined_versions.discard(version)
            self._sync_failures.pop(version, None)

    # ------------------------------------------------------------ weight views
    def _resolve_tier(self, name: str) -> LicenseTier:
        """A known tier, or one learned from the license server (and
        remembered, so a sync re-pulls it)."""
        tier = self.tiers.get(name)
        if tier is None and self._server is not None:
            # an unhealthy lease refuses NEW grants: every tier served
            # during an outage must have been validated while the server
            # was reachable (the pinned-view guarantee)
            if self._lease_state != "healthy":
                raise KeyError(
                    f"unknown license tier {name!r} (lease "
                    f"{self._lease_state}: refusing new tier grant)")
            try:
                tier = self.retry_policy.run(
                    lambda: self._transport.tier(self.model, name),
                    on_retry=self._count_wire_retry)
                self._lease_renew()
                self.tiers[name] = tier
                self._server_tiers.add(name)
                if self.obs:
                    self.audit.record("tier_grant", model=self.model,
                                      tier=name, version=self.version,
                                      source="server")
            except KeyError:
                tier = None
            except TransportError as exc:
                raise KeyError(
                    f"unknown license tier {name!r} (license server "
                    f"unreachable: {exc})") from exc
        if tier is None:
            raise KeyError(f"unknown license tier {name!r}")
        return tier

    def _materialize(self, tier_name: str, version: Optional[int]):
        """Build the (params, intervals) view served to one (tier,
        version): the interval-masked float weights, the fused
        masked-dequant of the int8 store (``materialize_int8_views``),
        both with intervals ``None``; or the int8 store itself with the
        tier's intervals packed on the device, dequantized inside every
        step.  A ``compiled.View``: its decode and prefill graphs live
        and go with it (in-scan, with the version's views)."""
        tier = self._resolve_tier(tier_name)
        if self.obs:
            self.audit.record("view_materialize", model=self.model,
                              tier=tier_name, version=version,
                              fingerprint=tier.fingerprint())
        base = self._weights[version]
        if not self.quantized:
            params = apply_license(base, tier)
            return View(params, None, GraphSet(params))
        if self.materialize_int8_views:
            from repro_torch.serving.quantized import materialize_licensed_view

            params = materialize_licensed_view(base, tier, self.cfg.dtype)
            return View(params, None, GraphSet(params))
        from repro_torch.serving.quantized import tier_intervals

        return View(base, tier_intervals(tier, self.device),
                    self._store_graphs.get(version, base))

    # ------------------------------------------------------ scheduler callbacks
    def _suffix_bucket(self, req: GatewayRequest, fresh: bool = False) -> int:
        """Prefix-aware admission probe of the bucket prefill: the
        uncached suffix width this request would prefill at —
        ``max_prompt`` when cold, down to 1 for a full match (the last
        position always recomputes).  Uses the side-effect-free
        :meth:`PrefixCache.peek` and caches the answer on the request
        keyed by the cache's mutation epoch.  ``fresh=True`` bypasses
        that cache: the scheduler re-validates every selected member at
        formation, since a cached probe is a hint, not a fact."""
        cached = None if fresh else getattr(req, "_suffix_probe", None)
        if cached is not None and cached[0] == self.prefix.epoch:
            return cached[1]
        toks = right_align([req.prompt], self.max_prompt, 1)[0]
        matched = self.prefix.peek((req.license, req.version), toks)
        bucket = self.max_prompt - min(matched, self.max_prompt - 1)
        req._suffix_probe = (self.prefix.epoch, bucket)
        return bucket

    def _suffix_bucket_fresh(self, req: GatewayRequest) -> int:
        """Cache-bypassing probe for batch-formation re-validation."""
        return self._suffix_bucket(req, fresh=True)

    def _blocks_needed(self, req: GatewayRequest) -> int:
        """Chunked-admission block budget: blocks covering the TRUE
        prompt length — conservative, since adopted prefix blocks only
        reduce the fresh allocation."""
        return max(1, cdiv(len(req.prompt), self.pool.block_size))


# --------------------------------------------------------------------- tenants
def _pattern_match(pattern: str, value: str) -> bool:
    return pattern == "*" or pattern == value


class _Tenant:
    """One tenant's entitlements, limits, bucket state, and counters."""

    __slots__ = ("name", "entitlements", "max_concurrent", "rate", "burst",
                 "bucket", "last_refill", "inflight", "submitted", "admitted",
                 "completed", "tokens_generated", "quota_rejections")

    def __init__(self, name: str, entitlements: Iterable,
                 max_concurrent: Optional[int],
                 rate: Optional[float], burst: Optional[float]):
        self.name = name
        self.entitlements: set = set()
        for ent in entitlements:
            self.entitlements.add(_parse_entitlement(ent))
        self.max_concurrent = (None if max_concurrent is None
                               else int(max_concurrent))
        self.rate = None if rate is None else float(rate)
        self.burst = (float(burst) if burst is not None
                      else (self.rate if self.rate is not None else 0.0))
        if self.rate is not None and self.burst < 1.0:
            raise ValueError(
                f"burst={self.burst} < 1: tenant {name!r} could never "
                f"pass the rate limit")
        self.bucket = self.burst          # start full: a burst is allowed
        self.last_refill: Optional[float] = None
        self.inflight = 0
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.tokens_generated = 0
        self.quota_rejections = 0


def _parse_entitlement(ent) -> Tuple[str, str]:
    """Accept ``(model, tier)`` tuples or ``"model:tier"`` strings;
    ``"*"`` wildcards either side."""
    if isinstance(ent, str):
        model, _, tier = ent.partition(":")
        return (model or "*", tier or "*")
    model, tier = ent
    return (str(model), str(tier))


class TenantRegistry:
    """Per-tenant licensing enforcement: entitlements, quotas, rates.

    * **Entitlements** are (model, tier) patterns (``"*"`` wildcards
      either side): which licensed variants a tenant may request at all.
    * **Concurrency** (``max_concurrent``): live requests (queued or
      running, fleet-wide) per tenant.  ``0`` is a valid zero-quota
      tenant — entitled on paper, admitted never.  ``None`` = unlimited.
    * **Rate** (``rate`` requests/s refilled into a bucket of capacity
      ``burst``): a token bucket, charged one token per accepted submit,
      on the injectable ``clock``.

    :meth:`acquire` runs all three checks and charges on success;
    :meth:`cancel` refunds a charge whose request the gateway then
    bounced for non-tenant reasons; :meth:`drop_queued` settles a request
    rejected at batch formation (the rate token stays spent);
    :meth:`finish` settles a completed request.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._tenants: Dict[str, _Tenant] = {}
        # licensing ledger (tracing.AuditLog), wired by FleetGateway so
        # tenant definition changes land in the fleet's audit stream
        self.audit: Any = None

    # ------------------------------------------------------------- definition
    def register(self, name: str, *, entitlements: Iterable = ("*:*",),
                 max_concurrent: Optional[int] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None) -> None:
        """Define (or redefine) a tenant.  Redefinition keeps live
        inflight/usage counters, so re-provisioning a tenant mid-flight
        cannot leak or double-count its running requests."""
        fresh = _Tenant(name, entitlements, max_concurrent, rate, burst)
        old = self._tenants.get(name)
        if old is not None:
            for k in ("inflight", "submitted", "admitted", "completed",
                      "tokens_generated", "quota_rejections"):
                setattr(fresh, k, getattr(old, k))
        self._tenants[name] = fresh
        if self.audit is not None:
            self.audit.record(
                "tenant_register", tenant=name,
                entitlements=sorted(f"{m}:{t}" for m, t in fresh.entitlements),
                max_concurrent=fresh.max_concurrent, rate=fresh.rate)

    def grant(self, name: str, model: str = "*", tier: str = "*") -> None:
        self._tenants[name].entitlements.add((model, tier))
        if self.audit is not None:
            self.audit.record("entitlement_grant", tenant=name, model=model,
                              tier=tier)

    def revoke(self, name: str, model: str = "*", tier: str = "*") -> None:
        """Remove every entitlement pattern that would entitle (model,
        tier), broader wildcard patterns included; ``"*"`` arguments
        match any pattern component.  Queued requests of the tenant are
        rejected at the next batch formation; decoding ones complete."""
        t = self._tenants[name]
        t.entitlements = {
            (pm, pt) for (pm, pt) in t.entitlements
            if not ((model == "*" or _pattern_match(pm, model))
                    and (tier == "*" or _pattern_match(pt, tier)))}

    def known(self, name: str) -> bool:
        return name in self._tenants

    def entitled(self, name: str, model: str, tier: str) -> bool:
        t = self._tenants.get(name)
        if t is None:
            return False
        return any(_pattern_match(pm, model) and _pattern_match(pt, tier)
                   for (pm, pt) in t.entitlements)

    # ------------------------------------------------------------ enforcement
    def _refill(self, t: _Tenant) -> None:
        if t.rate is None:
            return
        now = self._clock()
        if t.last_refill is not None:
            t.bucket = min(t.burst, t.bucket + (now - t.last_refill) * t.rate)
        t.last_refill = now

    def acquire(self, name: str, model: str, tier: str) -> Optional[str]:
        """All submit-time checks; charges (inflight + one bucket token)
        and returns None on success, else the rejection reason."""
        t = self._tenants.get(name)
        if t is None:
            return f"unknown tenant {name!r}"
        t.submitted += 1
        if not self.entitled(name, model, tier):
            t.quota_rejections += 1
            return (f"tenant {name!r} is not entitled to "
                    f"({model!r}, {tier!r})")
        if t.max_concurrent is not None and t.inflight >= t.max_concurrent:
            t.quota_rejections += 1
            return (f"tenant {name!r} at its concurrent-request quota "
                    f"({t.max_concurrent})")
        if t.rate is not None:
            self._refill(t)
            if t.bucket < 1.0:
                t.quota_rejections += 1
                return (f"tenant {name!r} rate-limited "
                        f"({t.rate:g} req/s, burst {t.burst:g})")
            t.bucket -= 1.0
        t.inflight += 1
        t.admitted += 1
        return None

    def cancel(self, name: str) -> None:
        """Refund an :meth:`acquire` whose request the gateway bounced
        for non-tenant reasons: no service was rendered, so the rate
        token comes back too."""
        t = self._tenants[name]
        t.inflight -= 1
        t.admitted -= 1
        if t.rate is not None:
            t.bucket = min(t.burst, t.bucket + 1.0)

    def drop_queued(self, name: str) -> None:
        """Settle a request rejected at batch formation (entitlement
        revoked while it queued): a quota rejection; the rate token
        stays spent."""
        t = self._tenants[name]
        t.inflight -= 1
        t.quota_rejections += 1

    def finish(self, name: str, tokens: int) -> None:
        t = self._tenants.get(name)
        if t is None:                      # tenant deleted mid-flight
            return
        t.inflight -= 1
        t.completed += 1
        t.tokens_generated += int(tokens)

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name, t in self._tenants.items():
            self._refill(t)
            out[name] = {
                "inflight": t.inflight, "submitted": t.submitted,
                "admitted": t.admitted, "completed": t.completed,
                "tokens_generated": t.tokens_generated,
                "quota_rejections": t.quota_rejections,
                "max_concurrent": t.max_concurrent,
                "rate": t.rate,
                "rate_tokens_available": (None if t.rate is None
                                          else t.bucket),
                "entitlements": sorted(
                    f"{m}:{ti}" for (m, ti) in t.entitlements),
            }
        return out


# ----------------------------------------------------------------------- fleet
class FleetGateway:
    """N :class:`ModelSlot`\\ s behind one submit/step/run loop.

    ``add_model`` registers a model (constructing its wrapping
    ``LicensedGateway``); ``attach`` adopts an existing
    gateway (e.g. one booted by ``LicensedGateway.from_server``).
    ``submit`` routes by model name and enforces the
    :class:`TenantRegistry`; ``step`` executes ONE micro-batch —
    round-robin over slots with work — plus at most ONE slot's active
    update-stager step; ``run`` drains every slot's queue.

    ``cache_budget_bytes`` caps the *sum* of allocated cache-block bytes
    across every slot (see the module docstring).  ``None`` = no global
    cap (each slot is bounded by its own pool alone).
    """

    def __init__(self, *, cache_budget_bytes: Optional[int] = None,
                 tenants: Optional[TenantRegistry] = None,
                 telemetry: Any = True,
                 clock: Optional[Callable[[], float]] = None,
                 sanitize: Optional[bool] = None):
        self.cache_budget_bytes = (None if cache_budget_bytes is None
                                   else int(cache_budget_bytes))
        self.sanitize = sanitize           # default for add_model slots
        # one shared registry for the whole fleet: ``add_model`` passes
        # it to every slot (distinct {"model": name} labels keep their
        # instruments apart), ``attach`` adopts a standalone gateway's
        self.clock = clock if clock is not None else time.perf_counter
        if isinstance(telemetry, Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = Telemetry(clock=self.clock, enabled=bool(telemetry))
        self.obs = self.telemetry.enabled
        self.audit = AuditLog(clock=self.clock, enabled=self.obs)
        self.tenants = (tenants if tenants is not None
                        else TenantRegistry(clock=self.clock))
        self.tenants.audit = self.audit
        self.gateways: Dict[str, Any] = {}
        self._rr = 0                       # slot round-robin cursor
        self._stager_rr = 0                # stager round-robin cursor
        self._steps = 0
        self._t0: Optional[float] = None   # first-step timestamp (tokens/s)
        self._register_telemetry()

    # ---------------------------------------------------------- observability
    def _register_telemetry(self) -> None:
        """Fleet-level instruments: budget occupancy gauges plus a
        dynamic per-tenant collector (tenants register at any time, so
        their series are enumerated at scrape time)."""
        t = self.telemetry
        t.gauge("fleet_models", help="Registered model slots",
                fn=lambda: len(self.gateways))
        t.counter("fleet_steps_total", help="Fleet scheduler iterations",
                  fn=lambda: self._steps)
        t.gauge("fleet_cache_budget_bytes",
                help="Global cache byte budget (0 = uncapped)",
                fn=lambda: self.cache_budget_bytes or 0)
        t.gauge("fleet_cache_used_bytes",
                help="Cache block bytes allocated fleet-wide",
                fn=self.used_cache_bytes)
        t.gauge("fleet_cache_reclaimable_bytes",
                help="Bytes held only by retained prefix chains",
                fn=self.reclaimable_cache_bytes)
        t.register_collector(self._tenant_collector)
        t.declare(*FLEET_METRICS_KEYS)

    def _tenant_collector(self):
        for name, s in self.tenants.stats().items():
            lb = {"tenant": name}
            yield ("tenant_inflight", "gauge",
                   "Live (queued or running) requests", lb, s["inflight"])
            yield ("tenant_submitted_total", "counter",
                   "Requests submitted", lb, s["submitted"])
            yield ("tenant_completed_total", "counter",
                   "Requests completed", lb, s["completed"])
            yield ("tenant_tokens_generated_total", "counter",
                   "Tokens delivered", lb, s["tokens_generated"])
            yield ("tenant_quota_rejections_total", "counter",
                   "Entitlement/concurrency/rate rejections", lb,
                   s["quota_rejections"])

    def render_prometheus(self) -> str:
        """One scrape page covering every slot plus the fleet gauges."""
        return self.telemetry.render_prometheus()

    def chrome_trace(self) -> str:
        """Whole-fleet Chrome trace: one pid per model, one timebase."""
        return merge_chrome_traces(
            (name, gw.tracer) for name, gw in self.gateways.items())

    def audit_events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        """Fleet-wide licensing ledger: the fleet's own records (tenant
        definitions, quota rejections) merged with every slot's, ordered
        by (ts, seq)."""
        merged = AuditLog.merge([self.audit] + [gw.audit for gw in self.gateways.values()])
        if event is not None:
            merged = [e for e in merged if e["event"] == event]
        return merged

    # ------------------------------------------------------------ registration
    def add_model(self, name: str, cfg: ModelConfig, params: Any, **kw) -> Any:
        """Construct and register one model's gateway.  ``kw`` are
        ``LicensedGateway`` knobs (tiers, pool geometry, ``device``)."""
        from repro_torch.serving.gateway import LicensedGateway

        kw.pop("model", None)
        kw.setdefault("telemetry", self.telemetry)
        kw.setdefault("clock", self.clock)
        kw.setdefault("sanitize", self.sanitize)
        return self.attach(LicensedGateway(cfg, params, model=name, **kw))

    def attach(self, gw: Any) -> Any:
        """Adopt an existing ``LicensedGateway`` as one slot (keyed by
        its ``model`` name) and wire the fleet hooks into its slot and
        scheduler."""
        name = gw.model
        if name in self.gateways:
            raise ValueError(f"model {name!r} already registered")
        if gw.slot.fleet is not None:
            raise ValueError(f"gateway {name!r} already belongs to a fleet")
        if self.cache_budget_bytes is not None and gw.paged:
            # every paged slot must be able to run one full-capacity
            # request to completion even when every OTHER slot holds one
            # too: otherwise a budget-bound fleet can admit requests that
            # no reclaim or (within-slot) preemption can ever finish
            need = sum(cdiv(g.capacity, g.pool.block_size) * g.pool.block_bytes
                       for g in list(self.gateways.values()) + [gw] if g.paged)
            if need > self.cache_budget_bytes:
                raise ValueError(
                    f"cache_budget_bytes={self.cache_budget_bytes} cannot "
                    f"hold one full request per paged slot ({need} bytes "
                    f"across {len(self.gateways) + 1} models)")
        gw.slot.fleet = self
        gw.slot.on_finish = self._on_finish
        if gw.paged:
            gw.scheduler.global_budget = lambda g=gw: self._slot_headroom(g)
        gw.scheduler.admission_filter = lambda r, g=gw: self._admission_ok(g, r)
        # a standalone gateway brings its own registry: fold its
        # instruments into the fleet's scrape page (a no-op for
        # add_model slots, which already share self.telemetry)
        self.telemetry.adopt(gw.telemetry)
        self.gateways[name] = gw
        return gw

    def _paged(self) -> List[Any]:
        """The slots on a block-paged pool: the only ones the byte budget
        counts (a contiguous pool is reserved whole at construction)."""
        return [g for g in self.gateways.values() if g.paged]

    # ---------------------------------------------------------- global budget
    def used_cache_bytes(self) -> int:
        """Bytes of cache blocks allocated fleet-wide (running requests'
        chains AND retained prefix chains), from host counters."""
        return sum(g.pool.block_bytes * g.pool.allocator.num_held
                   for g in self._paged())

    def reclaimable_cache_bytes(self) -> int:
        """Bytes held only by prefix-cache retained chains: freeable on
        demand, so they count as admission headroom."""
        return sum(g.pool.block_bytes * g.prefix.reclaimable()
                   for g in self._paged() if g.prefix is not None)

    def _slot_headroom(self, gw: Any) -> int:
        """How many MORE of ``gw``'s blocks the fleet budget can cover,
        counting every slot's reclaimable chains as free (the
        ``Scheduler.global_budget`` hook)."""
        if self.cache_budget_bytes is None:
            return gw.pool.num_blocks
        free = (self.cache_budget_bytes - self.used_cache_bytes()
                + self.reclaimable_cache_bytes())
        return max(0, int(free) // gw.pool.block_bytes)

    def _ensure_headroom(self, gw: Any, n: int) -> bool:
        """Make strict room for ``n`` of ``gw``'s blocks under the
        budget, evicting retained prefix chains — ``gw``'s own first
        (freeing them also helps its local allocation), then other
        slots', LRU within each, always through the owning slot's
        ``PrefixCache`` (a slot's graphs refill their tables before every
        replay, so a block freed here is never read through a stale
        table).  False when the budget still cannot cover it (every
        remaining byte is pinned by running requests): the caller falls
        back to within-slot preemption."""
        if self.cache_budget_bytes is None:
            return True
        need = n * gw.pool.block_bytes

        def free() -> int:
            return self.cache_budget_bytes - self.used_cache_bytes()

        if free() >= need:
            return True
        for g in [gw] + [g for g in self._paged() if g is not gw]:
            if g.prefix is None:
                continue
            while free() < need and g.prefix.reclaimable() > 0:
                want = cdiv(need - free(), g.pool.block_bytes)
                if g.prefix.evict(want) == 0:
                    break
        return free() >= need

    # -------------------------------------------------------------- admission
    def _admission_ok(self, gw: Any, req: GatewayRequest) -> bool:
        """Batch-formation entitlement re-check (``admission_filter``):
        a tenant revoked since submit must not reach a lane.  In-flight
        requests are never revisited: a revocation drains, it never
        cancels."""
        if req.tenant is None:
            return True
        if self.tenants.entitled(req.tenant, gw.model, req.license):
            return True
        req.state = RequestState.REJECTED
        req.error = (f"tenant {req.tenant!r} entitlement to "
                     f"({gw.model!r}, {req.license!r}) revoked while queued")
        self.tenants.drop_queued(req.tenant)
        gw.stats["quota_rejections"] += 1
        gw.stats["rejected"] += 1
        if self.obs:
            self.audit.record("tenant_reject", tenant=req.tenant,
                              model=gw.model, tier=req.license,
                              reason="entitlement revoked while queued")
        return False

    def _rejected(self, model: str, prompt, tenant: Optional[str], license: str,
                  error: str) -> GatewayRequest:
        req = GatewayRequest(prompt=np.asarray(prompt, np.int32).reshape(-1),
                             license=license, model=model, tenant=tenant)
        req.state = RequestState.REJECTED
        req.error = error
        return req

    def submit(self, model: str, prompt, *, tenant: Optional[str] = None,
               license: str = "full", **kw) -> GatewayRequest:
        """Route one request to its model slot, enforcing the tenant's
        entitlements, concurrency quota and rate limit first.  A
        rejection (tenant or gateway) returns a REJECTED request with
        ``error`` set, as single-gateway admission does."""
        gw = self.gateways.get(model)
        if gw is None:
            return self._rejected(model, prompt, tenant, license,
                                  f"unknown model {model!r}")
        if tenant is not None:
            reason = self.tenants.acquire(tenant, model, license)
            if reason is not None:
                gw.stats["quota_rejections"] += 1
                gw.stats["rejected"] += 1
                if self.obs:
                    self.audit.record("quota_reject", tenant=tenant,
                                      model=model, tier=license,
                                      reason=reason)
                return self._rejected(model, prompt, tenant, license, reason)
        req = gw.submit(prompt, license=license, tenant=tenant, **kw)
        if tenant is not None and req.state is RequestState.REJECTED:
            # bounced after the quota charge for a non-tenant reason
            # (bad prompt length, unknown tier, bad seed): refund
            self.tenants.cancel(tenant)
        return req

    # -------------------------------------------------------------- execution
    def step(self) -> Optional[Any]:
        """ONE fleet iteration: the next slot (round-robin) with work
        runs one micro-batch, and at most ONE slot's active update
        stager advances one bounded step.  Returns the executed
        ``ScheduledAction`` (its ``model`` field names the slot), or
        None when no slot has work."""
        if self._t0 is None:
            self._t0 = self.clock()
        self._steps += 1
        order = list(self.gateways.values())
        act = None
        n = len(order)
        for i in range(n):
            gw = order[(self._rr + i) % n]
            act = gw.step(drive_stager=False)
            if act is not None:
                self._rr = (self._rr + i + 1) % n
                break
        else:
            self._rr = (self._rr + 1) % n if n else 0
        syncing = [g for g in order if g.sync_active]
        if syncing:
            try:
                syncing[self._stager_rr % len(syncing)].sync_step()
            except TransportError:
                # retries exhausted: the stager already aborted (weights
                # dropped, failure counted toward quarantine); the slot
                # keeps serving its current version
                pass
            self._stager_rr += 1
        return act

    def run(self, max_steps: int = 1_000_000) -> List[GatewayRequest]:
        """Drain every slot's queue; returns requests completed during
        this call (all models interleaved, in completion order).  Active
        staged syncs keep stepping after the queues empty, so returning
        implies any begun version flip landed."""
        drained: List[GatewayRequest] = []
        for gw in self.gateways.values():
            gw._drain_sink = drained
        try:
            for _ in range(max_steps):
                if self.step() is None and not any(
                        g.sync_active for g in self.gateways.values()):
                    break
        finally:
            for gw in self.gateways.values():
                gw._drain_sink = None
        return drained

    def _on_finish(self, req: GatewayRequest) -> None:
        if req.tenant is not None:
            self.tenants.finish(req.tenant, len(req.out_tokens))

    # ----------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, Any]:
        """Three sections: ``fleet`` (budget + totals), ``models`` (one
        per slot: the single-gateway ``LicensedGateway.metrics()``
        schema plus a fleet-computed ``tokens_per_s``) and ``tenants``
        (registry counters + live blocks held + oldest queue wait, per
        tenant), as ``telemetry.validate_fleet_metrics`` asserts."""
        now = self.clock()
        elapsed = (now - self._t0) if self._t0 is not None else 0.0
        models: Dict[str, Any] = {}
        for name, gw in self.gateways.items():
            toks = gw.stats["tokens_generated"]
            models[name] = {**gw.metrics(),
                            "tokens_per_s": (toks / elapsed if elapsed > 0 else 0.0)}
        tenants = self.tenants.stats()
        for t in tenants.values():
            t["blocks_held"] = 0
            t["oldest_wait_s"] = 0.0
            t["tokens_per_s"] = (t["tokens_generated"] / elapsed
                                 if elapsed > 0 else 0.0)
        for gw in self.gateways.values():
            slot_now = gw.clock()          # slot timestamps, slot clock
            for r in gw.scheduler.running:
                if r.tenant in tenants:
                    tenants[r.tenant]["blocks_held"] += len(r.blocks)
            for r in gw.scheduler.waiting:
                if r.tenant in tenants:
                    t = tenants[r.tenant]
                    t["oldest_wait_s"] = max(t["oldest_wait_s"],
                                             slot_now - r.submit_t)
        fleet = {
            "models": len(self.gateways),
            "steps": self._steps,
            "cache_budget_bytes": self.cache_budget_bytes,
            "cache_used_bytes": self.used_cache_bytes(),
            "cache_reclaimable_bytes": self.reclaimable_cache_bytes(),
            "tokens_generated": sum(m["tokens_generated"] for m in models.values()),
            "completed": sum(m["completed"] for m in models.values()),
            "quota_rejections": sum(m["quota_rejections"] for m in models.values()),
            "oldest_wait_s": max(
                [m["oldest_wait_s"] for m in models.values()] or [0.0]),
        }
        return {"fleet": fleet, "models": models, "tenants": tenants}
