"""Per-model serving state of the port: ``ModelSlot``.

Counterpart of the part of ``repro/serving/fleet.py::ModelSlot`` that a
single licensed gateway uses: the weight store, the (tier, version)-keyed
view cache, the block-paged KV pool, the chunked-prefill scheduler and
the serving stats.  ``LicensedGateway`` (``gateway.py``) wraps one slot
and forwards attribute access to it, as in the JAX package.  The fleet
itself (``FleetGateway``, tenants, the global cache budget) is not ported
yet.

Constructor arguments of the JAX slot whose features are not ported are
still recognised: passing the value the port implements is accepted,
anything else raises ``NotImplementedError`` naming the ROADMAP.md item
that ports it — never accepted and then ignored.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import FULL_TIER, LicenseTier, apply_license
from repro_torch.models.model import check_supported
from repro_torch.serving.paging import PagedCachePool, cdiv
from repro_torch.serving.scheduler import GatewayRequest, Scheduler, TierViewCache

# argument -> (the value the port implements, ROADMAP.md item for the rest)
_LEFT_OUT: Dict[str, Tuple[Any, str]] = {
    "prefix_cache": (False, "the prefix cache (serving/prefix.py)"),
    "telemetry": (False, "telemetry and tracing"),
    "sanitize": (None, "telemetry and tracing"),
    "paged": (True, "the other architectures"),
    "kernel_decode": (True, "the other architectures"),
    "server": (None, "staged sync"),
    "transport": (None, "staged sync"),
    "retry_policy": (None, "staged sync"),
    "quarantine_after": (None, "staged sync"),
    "lease_ttl_s": (None, "the fleet, tenants and lease"),
    "lease_grace_s": (None, "the fleet, tenants and lease"),
    "lease_policy": (None, "the fleet, tenants and lease"),
    "lease_floor_tier": (None, "the fleet, tenants and lease"),
}


def _check_left_out(kw: Dict[str, Any]) -> None:
    for name, value in kw.items():
        if name not in _LEFT_OUT:
            raise TypeError(f"unexpected argument {name!r}")
        ported, item = _LEFT_OUT[name]
        off = ported in (None, False) and not value
        if value is not None and value != ported and not off:
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
        materialize_int8_views: bool = False,
        max_batch: int = 8,
        max_prompt: int = 32,
        max_new_cap: int = 64,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_lanes: Optional[int] = None,
        decode_kernels: Optional[bool] = None,
        clock: Optional[Callable[[], float]] = None,
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
        self.quantized = bool(quantized)
        if self.quantized and not materialize_int8_views:
            raise NotImplementedError(
                "quantized=True without materialize_int8_views=True dequantizes "
                "inside every step; not ported yet, see ROADMAP.md, "
                "'the in-scan int8 dequant'")
        if self.quantized:
            from repro_torch.serving.quantized import quantize_serving_params

            params = quantize_serving_params(params)
        self.max_batch = int(max_batch)
        self.max_prompt = int(max_prompt)
        self.max_new_cap = int(max_new_cap)
        self.capacity = self.max_prompt + self.max_new_cap

        # one weight version until the update path is ported; requests
        # still pin it and views are keyed by it, as in the JAX package
        self.version = 1
        self._weights: Dict[int, Any] = {self.version: params}
        self.tiers: Dict[str, LicenseTier] = dict(tiers or {})
        self.tiers.setdefault("full", FULL_TIER)
        self.views = TierViewCache(self._materialize)

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
        # left-aligned chunked prefill, one block per chunk (the JAX
        # gateway's default)
        self.chunk_size = min(self.pool.block_size, self.max_prompt)
        self.scheduler = Scheduler(
            self.max_lanes, self.max_batch, allocator=self.pool.allocator,
            blocks_needed=self._blocks_needed, clock=self.clock)

        self.gateway: Any = None
        self._next_rid = 0
        # bounded: a long-lived gateway must not grow host memory with
        # every request served; metrics percentiles cover this window
        self.completed: "deque[GatewayRequest]" = deque(maxlen=10_000)
        self.trace: "deque[Tuple[str, str, Optional[int], int]]" = \
            deque(maxlen=10_000)
        self._drain_sink: Optional[List[GatewayRequest]] = None
        self.stats: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "completed": 0,
            "prefill_batches": 0, "decode_steps": 0, "tokens_generated": 0,
            "preempted": 0, "max_running": 0, "max_blocks_in_use": 0,
            "prefill_lane_tokens": 0, "prefill_chunks": 0,
        }

    # ------------------------------------------------------------ weight views
    def _resolve_tier(self, name: str) -> LicenseTier:
        tier = self.tiers.get(name)
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
        """Chunked-admission block budget: blocks covering the prompt."""
        return max(1, cdiv(len(req.prompt), self.pool.block_size))
