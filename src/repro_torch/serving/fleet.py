"""Per-model serving state of the port: ``ModelSlot``.

Counterpart of the part of ``repro/serving/fleet.py::ModelSlot`` that a
single licensed gateway uses: the weight versions, the (tier,
version)-keyed view cache, the block-paged KV pool, the shared-prefix
radix cache over it, the chunked-prefill scheduler, the serving stats,
the observability substrate (a ``Telemetry`` registry with the slot's
instruments, a ``TraceRecorder`` event tape and an ``AuditLog``, all on
the slot's clock), the opt-in sanitizer, and the license-server state of
the update path (transport, retry policy, sync failures and version
quarantine, tiers learned from the server, pending tier changes, the
active staged sync).
``LicensedGateway`` (``gateway.py``) wraps one slot and forwards
attribute access to it, as in the JAX package.  The fleet itself
(``FleetGateway``, tenants, the global cache budget) and the license
lease state machine are not ported yet: ``_lease_renew`` records the
time of the last good server exchange and nothing reads it.

Every constructor argument of the JAX slot is recognised.  Those whose
features are not ported accept the values the port implements (the JAX
default among them where the port behaves as the JAX slot does at that
default); anything else raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it — never accepted and then ignored.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.sanitize import ServingSanitizer, sanitize_from_env
from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import FULL_TIER, LicenseTier, apply_license
from repro_torch.core.transport import (DirectTransport, RetryPolicy, Transport,
                                        TransportDisconnect, TransportError,
                                        TransportTimeout)
from repro_torch.models.model import check_supported
from repro_torch.serving.paging import PagedCachePool, cdiv
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import GatewayRequest, Scheduler, TierViewCache
from repro_torch.serving.telemetry import GATEWAY_METRICS_KEYS, Telemetry
from repro_torch.serving.tracing import AuditLog, TraceRecorder

# argument -> (the values the port implements, ROADMAP.md item for the rest)
_LEFT_OUT: Dict[str, Tuple[Tuple[Any, ...], str]] = {
    "paged": ((True,), "the other architectures and the gateway fallbacks"),
    "kernel_decode": ((None, True), "the other architectures and the gateway fallbacks"),
    # None: one block per chunk, the JAX default; 0 is bucket prefill
    "chunk_size": ((None,), "the other architectures and the gateway fallbacks"),
    # None: the JAX slot's choice off a TPU ("off"); the port picks its
    # decode kernels with ``decode_kernels``
    "decode_pallas": ((None,), "the other architectures and the gateway fallbacks"),
    # the port samples on the device inside every step and keeps no logits
    "fuse_sampling": ((True,), "the rest of the package"),
    "record_logits": ((False,), "the rest of the package"),
    "lease_ttl_s": ((None,), "the fleet, tenants and lease"),
    "lease_grace_s": ((None,), "the fleet, tenants and lease"),
    "lease_policy": ((None,), "the fleet, tenants and lease"),
    "lease_floor_tier": ((None,), "the fleet, tenants and lease"),
}


def _check_left_out(kw: Dict[str, Any]) -> None:
    for name, value in kw.items():
        if name not in _LEFT_OUT:
            raise TypeError(f"unexpected argument {name!r}")
        ported, item = _LEFT_OUT[name]
        if value not in ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; see ROADMAP.md, {item!r}")


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
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_lanes: Optional[int] = None,
        watermark_blocks: int = 0,
        prefix_cache: bool = True,
        decode_kernels: Optional[bool] = None,
        view_capacity: int = 8,
        version: int = 1,
        server: Any = None,
        model: str = "model",
        clock: Optional[Callable[[], float]] = None,
        transport: Optional[Transport] = None,
        retry_policy: Optional[RetryPolicy] = None,
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
        if self.quantized and not materialize_int8_views:
            raise NotImplementedError(
                "quantized=True without materialize_int8_views=True dequantizes "
                "inside every step; not ported yet, see ROADMAP.md, "
                "'the in-scan int8 dequant'")
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

        # the kernel-resident decode routes its write and attention
        # through the Hopper kernels on a CUDA device; the plain path
        # serves the CPU and anyone who asks for it explicitly
        on_cuda = self.device.type == "cuda"
        if decode_kernels is None:
            decode_kernels = on_cuda
        if decode_kernels and not on_cuda:
            raise ValueError(f"decode_kernels=True needs a CUDA device, got "
                             f"{self.device}")
        self.decode_kernels = bool(decode_kernels)

        self.max_lanes = int(max_lanes or self.max_batch)
        bpl = cdiv(self.capacity, int(block_size))
        self.pool = PagedCachePool(
            cfg, self.max_lanes, self.capacity, int(block_size),
            int(num_blocks) if num_blocks is not None else self.max_lanes * bpl,
            device=self.device)
        prefill_blocks = max(1, cdiv(self.max_prompt, self.pool.block_size))
        if self.pool.num_blocks - int(watermark_blocks) < prefill_blocks:
            raise ValueError(
                f"watermark_blocks={watermark_blocks} leaves no room to "
                f"admit a prefill ({prefill_blocks} blocks of "
                f"{self.pool.num_blocks}) — the gateway would accept "
                f"requests and never schedule them")
        self.prefix = (PrefixCache(self.pool.allocator, self.pool.block_size)
                       if prefix_cache else None)
        # left-aligned chunked prefill, one block per chunk (the JAX
        # gateway's default)
        self.chunk_size = min(self.pool.block_size, self.max_prompt)
        self.scheduler = Scheduler(
            self.max_lanes, self.max_batch, allocator=self.pool.allocator,
            blocks_needed=self._blocks_needed,
            watermark_blocks=int(watermark_blocks),
            reclaimable=(self.prefix.reclaimable
                         if self.prefix is not None else None),
            clock=self.clock)
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
            for fam in ("prefix_prefill", "paged_decode"):
                rt.bound(fam, 4)
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
        self._lease_renewed_t = self.clock()  # guarded-by: owner(__init__, _lease_renew)
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

        self.gateway: Any = None
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
            # tenant enforcement lives with the fleet (not ported): a
            # standalone gateway never rejects on quota, so this stays 0
            "quota_rejections": 0,
            # fault tolerance: wire retries across all sync/tier calls,
            # the subset whose cause was a timeout/disconnect, and
            # versions quarantined after repeated failed syncs
            "sync_retries": 0, "sync_timeouts": 0, "sync_quarantines": 0,
        }

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
        instruments.  The lease series (``serving_license_lease_state``,
        ``serving_degraded_seconds_total``) come with the lease state
        machine, which is not ported."""
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

    # ------------------------------------------------------- license server
    def _lease_renew(self) -> None:
        """Record a successful server exchange (a timestamp store, safe
        from the background fetch worker)."""
        self._lease_renewed_t = self.clock()

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
        """Build the weight view served to one (tier, version): the
        interval-masked float weights, or the fused masked-dequant of the
        int8 store."""
        tier = self._resolve_tier(tier_name)
        if self.obs:
            self.audit.record("view_materialize", model=self.model,
                              tier=tier_name, version=version,
                              fingerprint=tier.fingerprint())
        base = self._weights[version]
        if not self.quantized:
            return apply_license(base, tier)
        from repro_torch.serving.quantized import materialize_licensed_view

        return materialize_licensed_view(base, tier, self.cfg.dtype)

    # ------------------------------------------------------ scheduler callbacks
    def _blocks_needed(self, req: GatewayRequest) -> int:
        """Chunked-admission block budget: blocks covering the TRUE
        prompt length — conservative, since adopted prefix blocks only
        reduce the fresh allocation."""
        return max(1, cdiv(len(req.prompt), self.pool.block_size))
