"""Per-model serving state of the port: ``ModelSlot``.

Counterpart of the part of ``repro/serving/fleet.py::ModelSlot`` that a
single licensed gateway uses: the weight versions, the (tier,
version)-keyed view cache, the block-paged KV pool, the shared-prefix
radix cache over it, the chunked-prefill scheduler, the serving stats,
and the license-server state of the update path (transport, retry
policy, sync failures and version quarantine, tiers learned from the
server, pending tier changes, the active staged sync).
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

from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import FULL_TIER, LicenseTier, apply_license
from repro_torch.core.transport import (DirectTransport, RetryPolicy, Transport,
                                        TransportDisconnect, TransportError,
                                        TransportTimeout)
from repro_torch.models.model import check_supported
from repro_torch.serving.paging import PagedCachePool, cdiv
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import GatewayRequest, Scheduler, TierViewCache

# argument -> (the values the port implements, ROADMAP.md item for the rest)
_LEFT_OUT: Dict[str, Tuple[Tuple[Any, ...], str]] = {
    "telemetry": ((False,), "telemetry and tracing"),
    "sanitize": ((None, False), "telemetry and tracing"),
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
            "prefill_batches": 0, "decode_steps": 0, "tokens_generated": 0,
            "preempted": 0, "max_running": 0, "max_blocks_in_use": 0,
            # prefix-cache accounting: lane-tokens actually run through the
            # prefill step, prompt tokens served from retained blocks, and
            # copy-on-write copies
            "prefill_lane_tokens": 0, "prefix_tokens_reused": 0,
            "cow_copies": 0,
            "prefill_chunks": 0,
            # fault tolerance: wire retries across all sync/tier calls,
            # the subset whose cause was a timeout/disconnect, and
            # versions quarantined after repeated failed syncs
            "sync_retries": 0, "sync_timeouts": 0, "sync_quarantines": 0,
        }

    # ------------------------------------------------------- license server
    def _lease_renew(self) -> None:
        """Record a successful server exchange (a timestamp store, safe
        from the background fetch worker)."""
        self._lease_renewed_t = self.clock()

    def _count_wire_retry(self, attempt: int, exc: BaseException,
                          delay: float, to_version: Optional[int] = None,
                          ) -> None:
        """RetryPolicy ``on_retry`` hook: counters per backoff."""
        self.stats["sync_retries"] += 1
        if isinstance(exc, (TransportTimeout, TransportDisconnect)):
            self.stats["sync_timeouts"] += 1

    def _note_sync_failure(self, version: int) -> None:
        """Count a consecutive failed sync toward quarantining ``version``."""
        n = self._sync_failures.get(version, 0) + 1
        self._sync_failures[version] = n
        if (n >= self.quarantine_after
                and version not in self.quarantined_versions):
            self.quarantined_versions.add(version)
            self.stats["sync_quarantines"] += 1

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
