"""Serving layer of the port: the licensed continuous-batching gateway
(gateway.py) over a per-model slot (fleet.py), the fleet that serves
many licensed models under one cache-byte budget with per-tenant
entitlements, quotas and rate limits (``FleetGateway``,
``TenantRegistry``, fleet.py), the scheduler
and the contiguous fallback pool (scheduler.py), the block-paged KV pool
(paging.py) and the shared-prefix
radix cache over it (prefix.py), the serving steps (engine.py), the int8
store with licensed views (quantized.py), the staged weight sync from
a license server (updates.py), and the observability layer: a
``Telemetry`` metrics registry with Prometheus text exposition
(telemetry.py), a ``TraceRecorder`` request-lifecycle tape with Chrome
trace_event export and an ``AuditLog`` licensing ledger (tracing.py)."""
from repro_torch.serving.engine import (prefill_chunk_step, prefill_step,
                                        prefill_suffix_step, right_align, sample_lane,
                                        serve_step, serve_step_paged, stack_lane_caches)
from repro_torch.serving.fleet import FleetGateway, ModelSlot, TenantRegistry
from repro_torch.serving.gateway import LicensedGateway
from repro_torch.serving.paging import BlockAllocator, PagedCachePool
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import (CachePool, GatewayRequest, RequestState,
                                           ScheduledAction, Scheduler,
                                           TierViewCache)
from repro_torch.serving.telemetry import (Counter, Gauge, Histogram, Telemetry,
                                           validate_fleet_metrics,
                                           validate_gateway_metrics)
from repro_torch.serving.tracing import (AuditLog, TraceRecorder,
                                         merge_chrome_traces, validate_chrome_trace)
from repro_torch.serving.updates import UpdateStager

__all__ = ["prefill_chunk_step", "prefill_step", "prefill_suffix_step", "right_align",
           "sample_lane", "serve_step", "serve_step_paged", "stack_lane_caches",
           "FleetGateway", "ModelSlot", "TenantRegistry", "LicensedGateway", "BlockAllocator",
           "CachePool", "PagedCachePool",
           "PrefixCache", "GatewayRequest", "RequestState", "ScheduledAction",
           "Scheduler", "TierViewCache", "UpdateStager",
           "Counter", "Gauge", "Histogram", "Telemetry", "TraceRecorder",
           "AuditLog", "merge_chrome_traces", "validate_chrome_trace",
           "validate_fleet_metrics", "validate_gateway_metrics"]
