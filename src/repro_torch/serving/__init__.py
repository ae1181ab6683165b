"""Serving layer of the port: the licensed continuous-batching gateway
(gateway.py) over a per-model slot (fleet.py), its scheduler
(scheduler.py), the block-paged KV pool (paging.py) and the shared-prefix
radix cache over it (prefix.py), the serving steps (engine.py), the int8
store with licensed views (quantized.py), the staged weight sync from
a license server (updates.py), and the observability layer: a
``Telemetry`` metrics registry with Prometheus text exposition
(telemetry.py), a ``TraceRecorder`` request-lifecycle tape with Chrome
trace_event export and an ``AuditLog`` licensing ledger (tracing.py)."""
from repro_torch.serving.engine import (prefill_chunk_step, sample_lane,
                                        serve_step_paged)
from repro_torch.serving.fleet import ModelSlot
from repro_torch.serving.gateway import LicensedGateway
from repro_torch.serving.paging import BlockAllocator, PagedCachePool
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import (GatewayRequest, RequestState,
                                           ScheduledAction, Scheduler,
                                           TierViewCache)
from repro_torch.serving.telemetry import (Counter, Gauge, Histogram, Telemetry,
                                           validate_gateway_metrics)
from repro_torch.serving.tracing import (AuditLog, TraceRecorder,
                                         merge_chrome_traces, validate_chrome_trace)
from repro_torch.serving.updates import UpdateStager

__all__ = ["prefill_chunk_step", "sample_lane", "serve_step_paged",
           "ModelSlot", "LicensedGateway", "BlockAllocator", "PagedCachePool",
           "PrefixCache", "GatewayRequest", "RequestState", "ScheduledAction",
           "Scheduler", "TierViewCache", "UpdateStager",
           "Counter", "Gauge", "Histogram", "Telemetry", "TraceRecorder",
           "AuditLog", "merge_chrome_traces", "validate_chrome_trace",
           "validate_gateway_metrics"]
