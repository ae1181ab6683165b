"""Licensed serving gateway of the port: continuous batching over
(tier, version)-keyed weight views, on the block-paged KV pool.

Counterpart of ``repro/serving/gateway.py::LicensedGateway`` in its main
configuration.  Requests tagged with a ``LicenseTier`` stream in; the
scheduler groups them into tier-homogeneous micro-batches, each served
through one cached licensed view of the single stored weight set (the
paper's one-stored-model-many-tiers claim, §3.5):

* float weights: the view is ``apply_license(base, tier)``;
* ``quantized=True, materialize_int8_views=True``: ONE int8 store, and
  the view is its fused masked-dequant (one CUDA launch per stacked
  leaf on the card).

Prompts prefill in left-aligned chunks (each lane at its own cursor,
``chunk_size`` tokens per prefill action, strictly alternating with
decode steps) into the pool through gathered per-lane views.  With the
shared-prefix radix cache (``serving/prefix.py``, ``prefix_cache=True``
by default) finished prompts' block chains are retained per (tier,
version), and a later prompt sharing a prefix adopts those blocks by
reference and prefills only the rest; write-back of adopted blocks goes
to the null block, and decode copy-on-writes a shared tail block
(``PagedCachePool.copy_block``) before its first write into it.  Decode is
kernel-resident: one batched step whose cache operands are the pool's
physical block tensors; the ``paged_decode_write`` kernel writes the new
K/V token per lane in place and ``paged_attention`` reads each live
cache byte once through the micro-batch's trimmed block tables.  When
the pool runs out of blocks, the youngest running request is preempted
back to the queue head and recomputed later (generation is deterministic
per (seed, prompt, view), so it reproduces its tokens).

The update path (paper §3.1.2, §4.3): :meth:`LicensedGateway.from_server`
boots the gateway as an edge pod of a ``LicenseServer`` by pulling the
full production snapshot through the delta protocol (the ``delta_apply``
kernel scatters it into the template on the card), and
:meth:`~LicensedGateway.begin_sync` / :meth:`~LicensedGateway.sync`
stage newer versions in bounded steps interleaved with serving
(``serving/updates.py``), flipping weights and tier redefinitions in
atomically at a step boundary; in-flight requests stay on the version
they were admitted under.

Observability rides along, as in the JAX package (``telemetry=True``
by default): pull-backed counters and gauges plus six latency histograms
in a ``Telemetry`` registry (:meth:`~LicensedGateway.render_prometheus`),
the request lifecycle, scheduler actions and stager phases on a
``TraceRecorder`` tape (:meth:`~LicensedGateway.chrome_trace`), and the
licensing audit stream (:meth:`~LicensedGateway.audit_events`).  Every
record site sits behind ``self.obs``.  The step histograms read the host
clock around ``step()``: a step's work up to its logits ends in the
token ids' copy to the host, but the prefill chunk's pool scatter and a
stage step's device work are only launched inside the window.
``sanitize=True`` (or ``REPRO_SANITIZE=1``) shadows the block allocator
and bounds the distinct step shapes.

Left out of this port so far (see ROADMAP.md): the license lease state
machine, fleets and tenant enforcement.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.transport import Transport, TransportError
from repro_torch.serving.engine import (lane_generator, prefill_chunk_step,
                                        sample_lane, serve_step_paged)
from repro_torch.serving.fleet import ModelSlot
from repro_torch.serving.paging import cdiv
from repro_torch.serving.scheduler import (GatewayRequest, RequestState,
                                           ScheduledAction)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (bounds the distinct step widths)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _sampling_key(reqs: List[GatewayRequest]) -> Tuple[bool, bool, bool]:
    """A micro-batch's sampling variant, the sanitizer's key as in the
    JAX package: (fused, any sampling lane, any top-k lane)."""
    with_rng = any(r.temperature > 0 for r in reqs)
    return (True, with_rng, with_rng and any(r.top_k for r in reqs))


class LicensedGateway:
    """Continuous-batching serving gateway with per-tier licensed views.

    Parameters
    ----------
    cfg, params:
        Model config and float weights (the port's nested dict, on
        ``device``).
    tiers:
        Name -> :class:`LicenseTier`; ``"full"`` is always available.
    quantized / materialize_int8_views:
        Serve from ONE int8 store (``params`` quantized here); each
        (tier, version) view is built once by the fused masked-dequant
        and cached.  ``quantized`` needs ``materialize_int8_views=True``
        in this port.
    already_quantized:
        ``params`` already is the int8 store (``quantize_serving_params``
        of the float weights); implies ``quantized``.
    max_batch:
        Lanes per micro-batch (the decode step's batch width).
    max_prompt / max_new_cap:
        Longest admitted prompt, and the decode budget per request.
    block_size / num_blocks / max_lanes:
        Paged-pool geometry; prompts prefill one block per chunk.
        ``num_blocks`` defaults to full provisioning (``max_lanes *
        ceil(capacity / block_size)``); size it smaller to oversubscribe
        and exercise preemption.
    watermark_blocks:
        Blocks admission keeps free (its budget is the free blocks above
        the watermark plus the prefix cache's reclaimable ones); one
        that leaves no room for a prefill raises ``ValueError``.
    prefix_cache:
        Retain finished prompts' KV blocks in a (tier, version)-scoped
        radix cache and serve later shared prefixes from them (default
        on; LRU-evicted under pool pressure).
    decode_kernels:
        Route the decode write and attention through the Hopper kernels.
        Default: on a CUDA device; ``True`` elsewhere raises, ``False``
        selects the plain path.
    view_capacity:
        Licensed views kept in the (tier, version) LRU cache.
    version / model:
        The weight version ``params`` are, and the model's name at the
        license server.
    server / transport / retry_policy:
        The ``LicenseServer`` this gateway syncs from (set by
        :meth:`from_server`), the wire seam every call to it goes
        through (a ``DirectTransport`` by default), and the retry policy
        of those calls.  Unknown tiers are resolved against the server.
    quarantine_after:
        Consecutive failed syncs toward one version before it is
        quarantined (no further sync attempts until cleared).
    history:
        Completed requests and scheduler actions kept for ``metrics``
        and ``trace`` (the newest ``history`` of each).
    telemetry:
        ``True`` (default): the slot's own ``Telemetry`` registry,
        trace tape and audit log; ``False``: nothing recorded; or a
        shared ``Telemetry`` to register the slot's instruments in.
    sanitize:
        Shadow the block allocator and bound the step shapes
        (``analysis/sanitize.py``); default: the ``REPRO_SANITIZE``
        environment variable.
    clock:
        Host clock for request timestamps, histograms, the trace and
        the audit (injectable for tests).
    device:
        Where the pool and the views live (default ``cuda``).
    """

    def __init__(self, cfg: ModelConfig, params: Any, **kw):
        self.slot = ModelSlot(cfg, params, **kw)
        self.slot.gateway = self

    def __getattr__(self, name: str):
        # reached only when normal lookup fails: slot state resolves here
        slot = object.__getattribute__(self, "__dict__").get("slot")
        if slot is None:
            raise AttributeError(name)
        return getattr(slot, name)

    def __setattr__(self, name: str, value: Any) -> None:
        slot = self.__dict__.get("slot")
        if slot is not None and hasattr(slot, name):
            setattr(slot, name, value)
        else:
            object.__setattr__(self, name, value)

    # ------------------------------------------------------------ server tiers
    def _refresh_server_tiers(self) -> None:
        """Re-pull tiers learned from the server.

        A redefined or revoked tier must not keep serving its old masks,
        but in-flight requests are never re-masked mid-generation: the
        change is deferred until the tier's requests drain, and while it
        is pending new admissions to the tier are refused.  Under a wire
        fault the refresh defers and the current tiers keep serving."""
        touched = False
        for name in list(self._server_tiers):
            try:
                fresh = self.retry_policy.run(
                    lambda n=name: self._transport.tier(self.model, n),
                    on_retry=self._count_wire_retry)
                touched = True
            except KeyError:
                fresh = None                       # revoked server-side
                touched = True
            except TransportError:
                if touched:
                    self._lease_renew()
                self._apply_pending_tiers()
                return
            cur = self.tiers.get(name)
            if fresh is not None and cur is not None and fresh.masks == cur.masks:
                self._pending_tiers.pop(name, None)
                continue
            self._pending_tiers[name] = fresh
        if touched:
            self._lease_renew()
        self._apply_pending_tiers()

    def _tier_in_flight(self, name: str) -> bool:
        return (any(r.license == name for r in self.scheduler.waiting)
                or any(r.license == name for r in self.scheduler.running))

    def _apply_pending_tiers(self) -> None:
        for name, fresh in list(self._pending_tiers.items()):
            if self._tier_in_flight(name):
                continue                           # defer until drained
            if fresh is None:
                self.tiers.pop(name, None)
                self._server_tiers.discard(name)
                if self.obs:
                    self.audit.record("tier_revoke", model=self.model,
                                      tier=name)
            else:
                self.tiers[name] = fresh
                if self.obs:
                    self.audit.record("tier_redefine", model=self.model,
                                      tier=name,
                                      fingerprint=fresh.fingerprint())
            self.views.invalidate(tier=name)
            if self.prefix is not None:
                # cached blocks encode the old mask's activations
                self.prefix.drop_scope(tier=name)
            del self._pending_tiers[name]

    def view_for(self, tier: str, version: Optional[int] = None):
        """Licensed weight view for (tier, version) — cached."""
        return self.views.get(tier, self.version if version is None else version)

    # ------------------------------------------------------------ telemetry
    def _span(self, req: GatewayRequest, name: Optional[str],
              attrs: Optional[Dict[str, Any]] = None) -> None:
        """Close the request's open lifecycle span and begin ``name``
        (None = just close).  Lifecycle phases (queue -> prefill ->
        decode) are sequential, never nested, so one slot per request
        suffices and every B gets its E."""
        if self.obs:
            if req._open_span is not None:
                self.tracer.end(req._open_span, req.rid)
            if name is not None:
                self.tracer.begin(name, req.rid, attrs)
        req._open_span = name

    def _note_admission(self, req: GatewayRequest) -> None:
        """A request leaves the queue for a lane: queue-wait histogram
        (first admission only — a restart's wait is preemption recovery),
        the admit/restart instant, and the prefill lifecycle span."""
        if not self.obs:
            return
        now = self.clock()
        if req.preemptions == 0:
            self.h_queue.observe(now - req.submit_t)
            name = "admit"
        else:
            name = "restart"
        self.tracer.instant(name, req.rid,
                            {"tier": req.license, "version": req.version,
                             "lane": req.lane})
        self._span(req, "prefill", {"tier": req.license,
                                    "version": req.version})

    def _note_first_token(self, req: GatewayRequest, now: float) -> None:
        """First token of a (possibly restarted) prefill: TTFT is counted
        ONCE per request — a preemption clears ``first_token_t`` but not
        ``_ttft_done``, so the restart's re-emission never double-counts."""
        req.first_token_t = now
        if not self.obs:
            return
        if not req._ttft_done:
            req._ttft_done = True
            self.h_ttft.observe(now - req.submit_t)
        self._span(req, "decode")

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every registered instrument."""
        return self.telemetry.render_prometheus()

    def chrome_trace(self) -> str:
        """This gateway's event tape as Chrome trace_event JSON."""
        return self.tracer.chrome_trace(process_name=self.model or "gateway")

    def audit_events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        """The licensing audit stream (optionally filtered by event)."""
        return self.audit.events(event)

    # -------------------------------------------------------------- admission
    def _reject(self, req: GatewayRequest, error: str) -> GatewayRequest:
        req.state = RequestState.REJECTED
        req.error = error
        self.stats["rejected"] += 1
        if self.obs:
            self.tracer.instant("reject", req.rid,
                                {"tier": req.license, "reason": error})
        return req

    def submit(self, prompt, *, license: str = "full", max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               seed: int = 0, tenant: Optional[str] = None) -> GatewayRequest:
        """Admit one request: validate the tier, pin the weight version.
        ``tenant`` is recorded for accounting (``metrics()["tenants"]``);
        a standalone gateway never polices it."""
        req = GatewayRequest(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=min(int(max_new_tokens), self.max_new_cap),
            license=license, tenant=tenant,
            # sub-epsilon temperatures are greedy (the sampler clamps its
            # divisor at 1e-6)
            temperature=0.0 if temperature <= 1e-6 else temperature,
            top_k=min(max(0, int(top_k)), self.cfg.padded_vocab), seed=seed,
        )
        req.rid = self._next_rid
        self._next_rid += 1
        req.submit_t = self.clock()
        try:
            if license in self._pending_tiers:
                # a pending revocation or redefinition refuses admissions:
                # nothing new is served under the superseded masks, so the
                # tier drains (and the change lands) in bounded time
                verb = ("revoked" if self._pending_tiers[license] is None
                        else "redefined; retry once in-flight requests "
                             "drain")
                raise KeyError(f"license tier {license!r} is being {verb}")
            self._resolve_tier(license)
        except KeyError as e:
            return self._reject(req, str(e))
        if not 1 <= len(req.prompt) <= self.max_prompt:
            return self._reject(req, f"prompt length {len(req.prompt)} "
                                     f"outside [1, {self.max_prompt}]")
        if req.max_new_tokens < 1:
            return self._reject(req, "max_new_tokens < 1")
        if not -2**31 <= int(seed) < 2**31:
            return self._reject(req, f"seed {seed} outside int32 range")
        req.version = self.version
        self.scheduler.submit(req)
        self.stats["admitted"] += 1
        if self.obs:
            self.tracer.instant(
                "submit", req.rid,
                {"tier": req.license, "version": req.version,
                 "model": self.model, "tenant": req.tenant,
                 "prompt_tokens": len(req.prompt),
                 "max_new_tokens": req.max_new_tokens})
            self._span(req, "queue")
        return req

    # ------------------------------------------------------------- scheduling
    def step(self, *, drive_stager: bool = True) -> Optional[ScheduledAction]:
        """Run ONE scheduler iteration (one prefill chunk or one decode
        micro-batch), plus — when a staged weight sync is active — ONE
        bounded stager step, so a version bump's work rides along with
        serving instead of stalling it."""
        act = self.scheduler.next_action()
        if act is not None:
            t0 = self.clock() if self.obs else 0.0
            if act.kind == "prefill":
                self._run_chunked_prefill(act)
            else:
                self._run_decode(act)
            if self.obs:
                # host clock: the window covers the step's work up to the
                # token ids' copy to the host, and only the launch of
                # what follows it (the prefill chunk's pool scatter)
                t1 = self.clock()
                (self.h_prefill if act.kind == "prefill"
                 else self.h_decode).observe(t1 - t0)
                self.tracer.complete("sched:" + act.kind, t0, t1,
                                     attrs={"tier": act.tier,
                                            "version": act.version,
                                            "batch": len(act.requests)})
                self.tracer.counter("queue_depth", len(self.scheduler.waiting))
                self.tracer.counter("running", len(self.scheduler.running))
                self.tracer.counter("blocks_held", self.pool.allocator.num_held)
        if drive_stager and self._stager is not None and self._stager.active:
            try:
                self._stager.step()
            except TransportError:
                # retries exhausted: the stager aborted inside step()
                # (staged weights dropped, failure counted toward
                # quarantine); serving continues on the current version
                pass
        if self.sanitizer is not None and act is not None:
            self.sanitizer.after_step(self)
        if act is None:
            return None
        # a decode whose whole batch was preempted executed nothing
        if act.requests:
            self.trace.append((act.kind, act.tier, act.version,
                               len(act.requests)))
        return act

    def run(self, max_steps: int = 1_000_000) -> List[GatewayRequest]:
        """Drain the queue; returns requests completed during this call.
        An active staged sync keeps stepping after the queue empties, so
        returning from ``run`` implies any begun version flip landed."""
        drained: List[GatewayRequest] = []
        self._drain_sink = drained
        try:
            for _ in range(max_steps):
                if self.step() is None and not self.sync_active:
                    if self.sanitizer is not None:
                        # queue and lanes are empty: anything still held
                        # must be reachable through the prefix tree
                        self.sanitizer.check_drained(self)
                    break
        finally:
            self._drain_sink = None
        return drained

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor, reqs: List[GatewayRequest]) -> np.ndarray:
        """Per-lane epilogue of a step, on the device: greedy lanes take
        the argmax, sampling lanes draw from their own generator; only
        one token id per lane comes back to the host."""
        rows = logits[: len(reqs)]
        toks = torch.argmax(rows, -1).to(torch.int32)
        for i, r in enumerate(reqs):
            if r.temperature > 0:
                gen = lane_generator(r.seed, len(r.out_tokens), self.device)
                toks[i] = sample_lane(rows[i], gen, r.temperature, r.top_k)
        return toks.cpu().numpy()

    def _alloc_blocks(self, n: int) -> List[int]:
        """Allocate ``n`` blocks, reclaiming retained prefix chains (LRU)
        if the free list alone can't cover it.  The scheduler's admission
        budget counts reclaimable blocks, so this succeeds for any
        admitted prefill."""
        got = self.pool.allocator.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict(n - self.pool.allocator.num_free)
            got = self.pool.allocator.alloc(n)
        assert got is not None, "scheduler admitted past the block budget"
        return got

    def _decref_block(self, b: int) -> None:
        """Drop one request reference, keeping the prefix cache's O(1)
        reclaimable counter exact: when exactly one reference survives
        and it is the tree's, the block just became evictable."""
        if self.pool.allocator.decref(b) == 1 and self.prefix is not None:
            self.prefix.note_release(b)

    def _release_blocks(self, req: GatewayRequest) -> None:
        """Drop the request's reference on every block it holds.  Private
        blocks return to the free list; blocks shared with the prefix
        cache (or another request) stay alive under the remaining refs."""
        for b in req.blocks:
            self._decref_block(b)
        req.blocks = []

    def _scatter_tables(self, tables: np.ndarray,
                        reqs: List[GatewayRequest]) -> np.ndarray:
        """Write-back tables with every *shared* block redirected to the
        null block.  Shared blocks are immutable: a chunk re-writes the
        gathered bytes of adopted blocks and a fully matched prompt
        recomputes its last token into the shared tail — both redundant,
        and redirecting them keeps retained chains bit-stable under
        concurrent readers."""
        out = tables.copy()
        alloc = self.pool.allocator
        n_cols = out.shape[1]              # chunked prefill trims columns
        for i, r in enumerate(reqs):
            for j, b in enumerate(r.blocks[:n_cols]):
                if alloc.refcount(b) > 1:
                    out[i, j] = self.pool.null_block
        return out

    # ------------------------------------------------------ chunked prefill
    def _run_chunked_prefill(self, act: ScheduledAction) -> None:
        """One chunked-prefill action: admit newly scheduled requests
        (adopt cached prefix blocks, allocate the rest, take a lane, park
        the cursor past the reused tokens), then advance every member
        one ``chunk_size`` chunk — so a prompt no longer than one chunk
        reaches its first token in a single step."""
        if act.requests[0].state is not RequestState.PREFILLING:
            self._admit_chunked(act)
        self._run_prefill_chunk(act)

    def _admit_chunked(self, act: ScheduledAction) -> None:
        """Prefix-match every prompt on its true token ids (left
        alignment gives every prompt absolute positions from 0, so
        prompts of different lengths share a prefix's blocks), then
        allocate the uncached remainder.  Matching runs for the whole
        batch BEFORE any allocation: matching increfs the chains, so this
        batch's own allocation pressure can never evict a block another
        lane is about to adopt."""
        scope = (act.tier, act.version)
        reqs = act.requests
        matches: List[Tuple[List[int], int]] = []
        for r in reqs:
            if self.prefix is not None:
                blocks, ntok = self.prefix.match(scope, r.prompt)
            else:
                blocks, ntok = [], 0
            # always recompute >= 1 token: the first sampled token needs
            # the last prompt position's logits
            capped = min(ntok, len(r.prompt) - 1)
            if capped == 0 and blocks:
                # the cap zeroed a real match (1-token prompt): the
                # chain is unusable — release the match's references
                for b in blocks:
                    self._decref_block(b)
                blocks = []
            matches.append((blocks, capped))
        bs = self.pool.block_size
        for r, (blocks, capped) in zip(reqs, matches):
            self.scheduler.start(r)
            self._note_admission(r)
            if self.obs and capped:
                self.tracer.instant("prefix_hit", r.rid, {"tokens": capped})
            # a partial match adopts only FULL blocks (a partial tail
            # matches only when it covers the whole prompt), so the
            # uncached suffix starts on a block boundary and its chunks
            # never write a shared block
            fresh = self._alloc_blocks(
                max(0, cdiv(len(r.prompt), bs) - len(blocks)))
            r.blocks = list(blocks) + fresh
            r.cursor = capped
            r.prefix_tokens = capped
            self.stats["prefix_tokens_reused"] += capped
        self._note_block_use()
        self.stats["prefill_batches"] += 1
        self.stats["max_running"] = max(self.stats["max_running"],
                                        len(self.scheduler.running))

    def _run_prefill_chunk(self, act: ScheduledAction) -> None:
        """Advance every member by one left-aligned chunk.

        All lanes share the ``chunk_size`` width; a lane with fewer
        tokens left is right-padded with junk rows whose writes land
        past its real rows.  The gathered table covers cursor + width
        INCLUDING the junk, so the attend-cache slot clamp never folds a
        junk row onto a real one; junk lands in the lane's own later
        rows (overwritten before anything attends them) or the null
        block.  Write-back redirects shared (adopted) blocks to the null
        block.  Lane count and table width are rounded up to powers of
        two, as in the JAX package.  A lane whose cursor reaches the
        prompt end donates its true-token chain to the prefix cache,
        emits its first token and enters decode."""
        view = self.views.get(act.tier, act.version)
        reqs = act.requests
        w = self.chunk_size
        bs = self.pool.block_size
        b = min(self.max_batch, _pow2(len(reqs)))
        need = max(cdiv(r.cursor + w, bs) for r in reqs)
        cols = min(self.pool.blocks_per_lane, _pow2(need))
        if self.sanitizer is not None:
            self.sanitizer.retrace.note("prefill_chunk", (b, cols))
            self.sanitizer.retrace.note("prefix_prefill", _sampling_key(reqs))
        sub = np.zeros((b, w), np.int32)
        poss = np.zeros(b, np.int32)
        lasts = np.zeros(b, np.int64)
        fills = np.zeros(b, np.int32)
        valid = np.zeros(len(reqs), np.int32)
        for i, r in enumerate(reqs):
            v = min(w, len(r.prompt) - r.cursor)
            valid[i] = v
            sub[i, :v] = r.prompt[r.cursor: r.cursor + v]
            sub[i, v:] = int(r.prompt[-1])     # right pad: junk region
            poss[i] = r.cursor
            lasts[i] = v - 1
            fills[i] = r.cursor + v
        lane_ids = self.pool.pad_lanes([r.lane for r in reqs], b)
        tables = self.pool.pad_tables([r.blocks[:cols] for r in reqs], b,
                                      n_cols=cols)
        caches = self.pool.gather(tables)
        logits, caches = prefill_chunk_step(view, self.cfg, self._to_device(sub),
                                            caches, self._to_device(poss))
        rows = logits[torch.arange(b, device=self.device), self._to_device(lasts)]
        outs = self._sample(rows, reqs)
        caches = self.pool.override_counters(caches, fills)
        self.pool.scatter(lane_ids, self._scatter_tables(tables, reqs), caches)
        self.stats["prefill_lane_tokens"] += w * len(reqs)
        self.stats["prefill_chunks"] += 1
        now = self.clock()
        scope = (act.tier, act.version)
        for i, r in enumerate(reqs):
            r.cursor += int(valid[i])
            if self.obs:
                self.tracer.instant("prefill_chunk", r.rid,
                                    {"cursor": r.cursor,
                                     "tokens": int(valid[i])})
            if r.cursor < len(r.prompt):
                continue
            r.state = RequestState.RUNNING
            r.pos = len(r.prompt)
            self._note_first_token(r, now)
            if self.prefix is not None:
                # donate the TRUE-token chain (full blocks + partial
                # tail) so any later prompt sharing the prefix adopts it
                self.prefix.insert(scope, r.prompt, r.blocks)
            self._emit(r, int(outs[i]))

    # ------------------------------------------------------------ decode
    def _try_alloc_one(self) -> Optional[int]:
        """One block from the free list, reclaiming retained prefix chains
        if needed — never preempts.  None when the pool is truly full."""
        got = self.pool.allocator.alloc(1)
        if got is None and self.prefix is not None and self.prefix.evict(1):
            got = self.pool.allocator.alloc(1)
        return got[0] if got is not None else None

    def _grow_one(self, r: GatewayRequest,
                  keep: List[GatewayRequest]) -> Optional[int]:
        """One block for ``r``: from the free list, else by prefix-cache
        eviction, else by preempting the youngest running request.  None
        if ``r`` itself was preempted."""
        while True:
            got = self._try_alloc_one()
            if got is not None:
                return got
            victim = self.scheduler.youngest_running()
            if victim is r and len(self.scheduler.running) == 1:
                raise RuntimeError("block pool exhausted by a single request")
            self._preempt(victim)
            if victim in keep:
                keep.remove(victim)
            if victim is r:
                return None

    def _grow_block_tables(self, reqs: List[GatewayRequest]) -> List[GatewayRequest]:
        """Give every request the block its next decode write needs, and
        a *private* copy of it when the block is shared.

        On exhaustion, first evict retained (request-free) prefix chains
        LRU-first, then preempt youngest-first; a victim inside this
        micro-batch is dropped from it.  Terminates because the pool
        holds at least one full request, every eviction or preemption
        strictly drops references, and the oldest running request is
        never chosen while others run.

        Copy-on-write: the step writes position ``pos`` into block
        ``pos // bs``.  If that block is shared (a prompt tail donated to
        or adopted from the prefix cache), the request gets a fresh block
        holding a device copy and swaps its table entry, before the step
        writes the pool in place; the shared original stays pristine."""
        keep = list(reqs)
        bs = self.pool.block_size
        alloc = self.pool.allocator
        if self.prefix is not None:
            # reclaim the batch's whole shortfall — growth blocks plus a
            # copy per shared write target — in ONE eviction pass; only
            # mid-pass churn falls back to _try_alloc_one's evict(1)
            need = 0
            for r in keep:
                if r.state != RequestState.RUNNING:
                    continue
                tail = r.pos // bs
                need += max(0, tail + 1 - len(r.blocks))
                if tail < len(r.blocks) and alloc.refcount(r.blocks[tail]) > 1:
                    need += 1
            shortfall = need - alloc.num_free
            if shortfall > 0:
                self.prefix.evict(shortfall)
        for r in list(keep):
            if r.state != RequestState.RUNNING:
                continue                   # preempted earlier in this pass
            needed = r.pos // bs + 1
            while len(r.blocks) < needed:
                b = self._grow_one(r, keep)
                if b is None:
                    break                  # r was preempted
                r.blocks.append(b)
            if r.state != RequestState.RUNNING:
                continue
            tail = needed - 1              # block receiving this step's write
            if alloc.refcount(r.blocks[tail]) > 1:
                # shared write target: prefer a private copy, but with no
                # spare block (fully provisioned pool) take the tree's
                # reference back instead — forfeiting one tail's future
                # hits beats preempting a running request for a copy
                b = self._try_alloc_one()
                if b is None:
                    if (self.prefix is not None
                            and alloc.refcount(r.blocks[tail]) == 2
                            and self.prefix.forget_block(r.blocks[tail])):
                        continue           # unshared now: write in place
                    b = self._grow_one(r, keep)
                    if b is None:
                        continue           # r itself was preempted
                self.pool.copy_block(r.blocks[tail], b)
                self._decref_block(r.blocks[tail])
                r.blocks[tail] = b
                self.stats["cow_copies"] += 1
        self._note_block_use()
        return keep

    def _preempt(self, req: GatewayRequest) -> None:
        self._release_blocks(req)
        # the restart re-emits these tokens; keep the counter equal to
        # tokens actually delivered
        self.stats["tokens_generated"] -= len(req.out_tokens)
        if self.obs:
            self._span(req, None)
            self.tracer.instant("preempt", req.rid,
                                {"tokens_lost": len(req.out_tokens)})
        self.scheduler.preempt(req)
        if self.obs:
            # back at the queue head: the lifecycle re-enters its queue
            # phase until re-admission emits a "restart"
            self._span(req, "queue")
        self.stats["preempted"] += 1

    def _note_block_use(self) -> None:
        self.stats["max_blocks_in_use"] = max(
            self.stats["max_blocks_in_use"], self.pool.allocator.num_held)

    def _run_decode(self, act: ScheduledAction) -> None:
        """One kernel-resident decode step: the pool's block tensors ARE
        the cache operands; tables are trimmed to the batch's used width,
        so attention reads O(context) bytes, once, through the table."""
        act.requests = self._grow_block_tables(act.requests)
        if not act.requests:
            return                         # whole batch preempted
        if self.sanitizer is not None:
            # post-CoW: every table entry live, write targets private
            self.sanitizer.check_decode_writes(act.requests, self.pool)
        view = self.views.get(act.tier, act.version)
        reqs = act.requests
        lanes = self.pool.pad_lanes([r.lane for r in reqs], self.max_batch)
        toks = np.zeros((self.max_batch, 1), np.int32)
        poss = np.zeros(self.max_batch, np.int32)
        for i, r in enumerate(reqs):
            toks[i, 0] = r.out_tokens[-1]
            poss[i] = r.pos
        used = max(r.pos // self.pool.block_size + 1 for r in reqs)
        if self.sanitizer is not None:
            self.sanitizer.retrace.note("decode_width", used)
            self.sanitizer.retrace.note("paged_decode", _sampling_key(reqs))
        tables = self.pool.pad_tables([r.blocks[:used] for r in reqs],
                                      self.max_batch, used)
        caches = self.pool.decode_cache(lanes)
        logits, caches = serve_step_paged(view, self.cfg, self._to_device(toks),
                                          caches, self._to_device(tables),
                                          self._to_device(poss),
                                          kernel=self.decode_kernels)
        outs = self._sample(logits, reqs)
        self.pool.absorb_decode(lanes, caches)
        self.stats["resident_decode_steps"] += 1
        for i, r in enumerate(reqs):
            r.pos += 1
            if self.obs:
                self.tracer.instant("decode_step", r.rid, {"pos": r.pos})
            self._emit(r, int(outs[i]))
        self.stats["decode_steps"] += 1

    def _emit(self, req: GatewayRequest, tok: int) -> None:
        """Append one token and retire the request if it is finished."""
        req.out_tokens.append(tok)
        self.stats["tokens_generated"] += 1
        if self.obs:
            # inter-token gap: decode cadence only.  The first token has
            # no predecessor, and a preemption clears ``_last_tok_t`` —
            # the restart's recovery pause is not a decode gap.
            now = self.clock()
            if req._last_tok_t is not None:
                self.h_gap.observe(now - req._last_tok_t)
            req._last_tok_t = now
        if len(req.out_tokens) >= req.max_new_tokens:
            self.scheduler.finish(req)
            if self.obs:
                self._span(req, None)
                self.tracer.instant("finish", req.rid,
                                    {"tokens": len(req.out_tokens),
                                     "preemptions": req.preemptions,
                                     "blocks": len(req.blocks)})
            self._release_blocks(req)
            self.completed.append(req)
            if self._drain_sink is not None:
                self._drain_sink.append(req)
            self.stats["completed"] += 1
            self._gc_versions()

    # ---------------------------------------------------------- weight updates
    def update_weights(self, params: Any, *, version: Optional[int] = None) -> int:
        """Install new float weights under a new version (quantized here
        on an int8 gateway).  In-flight requests stay pinned to their
        admitted version; new admissions pin the new one; a version's
        views go once its last request drains."""
        if self.quantized:
            from repro_torch.serving.quantized import quantize_serving_params

            params = quantize_serving_params(params)
        version = self.version + 1 if version is None else int(version)
        if version < self.version:
            raise ValueError(f"version {version} is older than the current "
                             f"version {self.version}")
        if version in self._weights:
            # overwriting a live version: views built from the old
            # weights must not survive the swap — nor cached prefix
            # activations
            self.views.invalidate(version=version)
            if self.prefix is not None:
                self.prefix.drop_scope(version=version)
        prev = self.version
        self._weights[version] = params
        self.version = version
        if self.obs:
            self.audit.record("version_install", model=self.model,
                              from_version=prev, to_version=version)
        self._gc_versions()
        return version

    def _gc_versions(self) -> None:
        live = self.scheduler.pinned_versions() | {self.version}
        if self._staging_version is not None:
            # a staged sync pre-registers the incoming version (and may
            # have prewarmed its views) before any request pins it
            live.add(self._staging_version)
        for v in [v for v in self._weights if v not in live]:
            del self._weights[v]
            self.views.invalidate(version=v)
            if self.prefix is not None:
                self.prefix.drop_scope(version=v)
        if self._pending_tiers:
            self._apply_pending_tiers()

    # ------------------------------------------------------- protocol plumbing
    @classmethod
    def from_server(cls, cfg: ModelConfig, server, model: str, template: Any,
                    transport: Optional[Transport] = None,
                    retry: Any = None, **kw) -> "LicensedGateway":
        """Boot a gateway as an edge serving pod of ``server`` (Fig. 2).

        ``template`` is a zeroed parameter dict on the serving device;
        the full production snapshot is pulled through the §3.1.2 delta
        protocol into a copy of it (the ``delta_apply`` kernel on CUDA),
        and :meth:`sync` keeps pulling increments from then on.  An
        explicit ``transport`` routes every wire call (the boot pull
        included) through it; ``retry`` overrides the RetryPolicy."""
        from repro_torch.core.protocol import EdgeClient

        client = EdgeClient(model, template, license_name="full")
        client.request_update(transport if transport is not None else server,
                              retry=retry)
        gw = cls(cfg, client.params, server=server, model=model,
                 version=client.version, transport=transport,
                 **({} if retry is None else {"retry_policy": retry}), **kw)
        gw._client = client
        return gw

    def _register_staging(self, version: int, params: Any) -> None:
        """Pre-register a staged version's serving params so its views can
        be prewarmed before the flip; ``_gc_versions`` keeps it alive."""
        if version in self._weights:
            # overwriting a live version's weights: views and cached
            # prefix activations built from the old bytes must not
            # survive into the prewarm
            self.views.invalidate(version=version)
            if self.prefix is not None:
                self.prefix.drop_scope(version=version)
        self._staging_version = version
        self._weights[version] = params

    def _install_staged(self, version: int) -> None:
        """The stager's atomic flip: bump the served version AND apply the
        tier redefinitions published alongside it, with no scheduler
        iteration in between.  Prewarmed views survive; in-flight
        requests stay pinned to the version they were admitted under."""
        if version != self._staging_version:
            raise RuntimeError(f"flip to version {version}, but version "
                               f"{self._staging_version} is staged")
        if version < self.version:
            raise ValueError(f"version {version} is older than the current "
                             f"version {self.version}")
        prev = self.version
        self.version = version
        self._staging_version = None
        if self.obs:
            # the one choke point every flip funnels through (staged and
            # blocking syncs alike): one version_flip per bump
            self.audit.record("version_flip", model=self.model,
                              from_version=prev, to_version=version)
        if self._server is not None:
            self._refresh_server_tiers()
        self._gc_versions()

    def begin_sync(self, server: Any = None, **stager_kw) -> bool:
        """Start a *staged* (non-blocking) sync against the license server.

        Returns True when a newer production version exists and a staging
        session began: each later :meth:`step` carries one bounded unit
        of fetch/apply/requantize/prewarm work, and the new version flips
        in atomically at a step boundary.  Returns False when the client
        is already current (tier-only redefinitions apply at once), when
        the newer version is quarantined, or when a wire fault outlives
        the retry budget during the probe.  A sync already in progress is
        left to finish (True)."""
        server = server or self._server
        if server is None or self._client is None:
            raise RuntimeError("gateway was not booted with from_server()")
        if self._stager is not None and self._stager.active:
            return True
        from repro_torch.serving.updates import UpdateStager

        stager = UpdateStager(self, server, **stager_kw)
        try:
            if stager.begin():
                self._stager = stager
                return True
        except TransportError:
            pass
        return False

    def sync_step(self) -> Optional[str]:
        """Advance an active staged sync by one bounded unit (for callers
        driving the stager without scheduler traffic); returns the phase
        that executed, or None when no sync is active."""
        if self._stager is None or not self._stager.active:
            return None
        return self._stager.step()

    @property
    def sync_active(self) -> bool:
        return self._stager is not None and self._stager.active

    def sync(self, server: Any = None, **stager_kw) -> bool:
        """Pull newer production weights (and tier redefinitions) — a
        blocking loop over the same staged machinery as
        :meth:`begin_sync`, so the weights + tiers flip is atomic either
        way.  Returns True if a new version was installed."""
        flipped = False
        while self.sync_active:           # finish a staged sync first
            self._stager.step()
            flipped = True
        if not self.begin_sync(server, **stager_kw):
            return flipped
        while self.sync_active:
            self._stager.step()
        return True

    # ---------------------------------------------------------------- metrics
    def _tenant_breakdown(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant usage: live requests (queued/running), tokens
        generated, cache blocks held, completions in the history window.
        Tenant-less requests are not listed."""
        out: Dict[str, Dict[str, int]] = {}

        def _d(t: str) -> Dict[str, int]:
            return out.setdefault(t, {
                "inflight": 0, "queued": 0, "completed": 0,
                "tokens_generated": 0, "blocks_held": 0})

        for r in self.scheduler.running:
            if r.tenant is None:
                continue
            d = _d(r.tenant)
            d["inflight"] += 1
            d["blocks_held"] += len(r.blocks)
            d["tokens_generated"] += len(r.out_tokens)
        for r in self.scheduler.waiting:
            if r.tenant is None:
                continue
            d = _d(r.tenant)
            d["inflight"] += 1
            d["queued"] += 1
        for r in self.completed:
            if r.tenant is None:
                continue
            d = _d(r.tenant)
            d["completed"] += 1
            d["tokens_generated"] += len(r.out_tokens)
        return out

    def metrics(self) -> Dict[str, Any]:
        """Counters, queue-wait ages, pool occupancy and latency, in the
        JAX package's schema (``telemetry.GATEWAY_METRICS_KEYS``) plus
        ``decode_path.kernels`` (whether the decode step runs the Hopper
        kernels).  ``lease`` holds only what the port computes: the lease
        state machine is not ported."""
        out: Dict[str, Any] = dict(self.stats)
        out["model"] = self.model
        out["view_cache"] = self.views.stats()
        out["oldest_wait_s"] = self.scheduler.oldest_wait_s()
        out["queue_wait_by_tier"] = self.scheduler.queue_wait_by_tier()
        out["tenants"] = self._tenant_breakdown()
        out["cache_pool"] = {"paged": True, **self.pool.stats()}
        # "pallas": the JAX slot's value off a TPU
        out["decode_path"] = {"kernel_resident": True, "pallas": "off",
                              "kernels": self.decode_kernels}
        out["staged_update"] = ({"active": False} if self._stager is None
                                else {"active": self._stager.active,
                                      **self._stager.stats()})
        out["chunked_prefill"] = {"enabled": True, "chunk_size": self.chunk_size,
                                  "chunks": self.stats["prefill_chunks"]}
        # suffix-width grouping is the JAX package's bucket-prefill
        # admission; chunked mode admits per true prompt length
        out["admission_grouping"] = {"enabled": False,
                                     "batches_by_suffix_width": {}}
        out["lease"] = {
            "server_attached": self._server is not None,
            "renew_age_s": self.clock() - self._lease_renewed_t,
            "quarantined_versions": sorted(self.quarantined_versions),
            "pinned_views": len(self.scheduler.pinned_tier_versions()),
        }
        out["prefix_cache"] = {"enabled": self.prefix is not None}
        if self.prefix is not None:
            out["prefix_cache"].update(self.prefix.stats())
            out["prefix_cache"]["prefix_tokens_reused"] = \
                self.stats["prefix_tokens_reused"]
            out["prefix_cache"]["cow_copies"] = self.stats["cow_copies"]
        out["latency"] = {
            "ttft_s": self.h_ttft.summary(),
            "inter_token_s": self.h_gap.summary(),
            "queue_wait_s": self.h_queue.summary(),
            "step_prefill_s": self.h_prefill.summary(),
            "step_decode_s": self.h_decode.summary(),
            "stager_step_s": self.h_stager.summary(),
        }
        lats = [r.latency for r in self.completed if r.latency is not None]
        if lats:
            out["latency_p50_ms"] = float(np.percentile(lats, 50) * 1e3)
            out["latency_p99_ms"] = float(np.percentile(lats, 99) * 1e3)
        return out
