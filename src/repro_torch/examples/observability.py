"""Serving-wide observability on the port: traces, histograms,
Prometheus, audit.

Everything the serving stack does — admission, prefix hits, prefill
chunks, decode steps, preemptions, staged version flips, tenant quota
verdicts — lands on one always-on observability layer
(``serving/telemetry.py`` + ``serving/tracing.py``).  This example
drives a two-model, two-tenant fleet through a mid-run licensed weight
update and then dumps all three export surfaces:

1. boot a fleet: one slot synced from a ``LicenseServer`` (so versions
   can bump mid-run), one plain slot; register tenants "acme" and
   "hobby" (hobby concurrency-capped so a quota rejection shows up);
2. stream requests through both slots, then publish v2 on the license
   server and let a *staged* sync flip it in while decodes continue;
3. print one request's lifecycle span story off the trace tape;
4. dump the Prometheus text exposition (per-model labels, histogram
   buckets), the licensing audit JSONL (grants, materializations,
   sync begin/flip, quota rejections), and a whole-fleet Chrome trace
   (``--trace-out``, default ``obs_trace.json``; load it in Perfetto /
   chrome://tracing).

Run:  PYTHONPATH=src python -m repro_torch.examples.observability \
          [--device cpu] [--trace-out obs_trace.json]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import tree_map
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.examples import launches, parse, parser
from repro_torch.models import init_params
from repro_torch.serving import (FleetGateway, LicensedGateway, TenantRegistry,
                                 validate_chrome_trace)

SYNCED, PLAIN = "qwen2.5-3b", "mamba2-130m"
PROM_SERIES = ("serving_ttft_seconds_bucket", "serving_weight_version",
               "tenant_quota_rejections_total")


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--trace-out", default="obs_trace.json",
                    help="where to write the whole-fleet Chrome trace")
    args = parse(ap, argv)
    rng = np.random.default_rng(0)
    out = {}

    def prompt():
        return rng.integers(0, 500, 8, dtype=np.int32)

    # 1. fleet: a license-server-synced slot + a plain slot, two tenants
    cfg = smoke_variant(get_config(SYNCED))
    params = init_params(cfg, seed=0, device=args.device)
    server = LicenseServer(WeightStore(":memory:", row_limit=2048))
    server.publish(SYNCED, params, tag="v1")
    server.publish_tier(SYNCED, LicenseTier(name="free",
                                            masks={"*": ((0.0, 0.004),)}))
    template = tree_map(torch.zeros_like, params)
    gw = LicensedGateway.from_server(cfg, server, SYNCED, template,
                                     max_batch=2, max_prompt=8,
                                     max_new_cap=8, device=args.device)

    tenants = TenantRegistry()
    fleet = FleetGateway(tenants=tenants)
    fleet.attach(gw)                  # adopts the slot's telemetry too
    cfg2 = smoke_variant(get_config(PLAIN))
    fleet.add_model(PLAIN, cfg2, init_params(cfg2, seed=1, device=args.device),
                    tiers={"free": LicenseTier(name="free",
                                               masks={"*": ((0.0, 0.004),)})},
                    max_batch=2, max_prompt=8, max_new_cap=8, device=args.device)
    tenants.register("acme", entitlements=(f"{SYNCED}:*", f"{PLAIN}:*"))
    tenants.register("hobby", entitlements=(f"{PLAIN}:free",),
                     max_concurrent=1)
    print(f"[1] fleet online: {SYNCED} (license-server v1) + {PLAIN}; "
          f"tenants acme (both models) / hobby ({PLAIN} free, 1 at a time)")

    # 2. traffic + a mid-run version bump through the staged sync -----------
    reqs = [fleet.submit(SYNCED, prompt(), tenant="acme", license="free",
                         max_new_tokens=6),
            fleet.submit(PLAIN, prompt(), tenant="hobby", license="free",
                         max_new_tokens=4),
            fleet.submit(PLAIN, prompt(), tenant="hobby", license="free",
                         max_new_tokens=4),       # over hobby's cap
            fleet.submit(SYNCED, prompt(), tenant="acme", license="full",
                         max_new_tokens=6)]
    fleet.step()                                  # first prefill lands
    server.publish(SYNCED, tree_map(lambda x: x * 1.01, params), tag="v2")
    gw.begin_sync(max_step_bytes=4 << 20)         # staged, non-blocking
    fleet.run()                                   # decodes + flip interleave
    done = sum(r.state.value == "done" for r in reqs)
    out.update(done=done, version=gw.version, rejected=reqs[2].error,
               out_tokens=[len(r.out_tokens) for r in reqs])
    print(f"[2] drained {done} requests across a staged v1->v2 flip "
          f"(slot now at version {gw.version}); hobby's second request: "
          f"{reqs[2].error!r}")

    # 3. one request's lifecycle story off the trace tape -------------------
    story = fleet.gateways[SYNCED].tracer.span_names(reqs[0].rid)
    out["story"] = list(story)
    print(f"[3] request {reqs[0].rid} lifecycle: {' -> '.join(story)}")

    # 4. the three export surfaces ------------------------------------------
    m = fleet.metrics()
    lat = m["models"][SYNCED]["latency"]
    out["ttft_count"] = lat["ttft_s"]["count"]
    print(f"[4] {SYNCED} ttft p50/p99: {lat['ttft_s']['p50'] * 1e3:.1f}/"
          f"{lat['ttft_s']['p99'] * 1e3:.1f} ms over "
          f"{lat['ttft_s']['count']} requests")

    prom = fleet.render_prometheus()
    shown = [ln for ln in prom.splitlines()
             if ln.startswith(PROM_SERIES)][:8]
    out["prometheus"] = shown
    print("    Prometheus excerpt:")
    for ln in shown:
        print(f"      {ln}")

    print("    audit stream:")
    out["audit"] = []
    for ev in fleet.audit_events():
        keys = {k: v for k, v in ev.items() if k not in ("ts", "seq")}
        out["audit"].append(keys)
        print(f"      {keys}")

    trace = fleet.chrome_trace()
    events = validate_chrome_trace(trace)         # parseable + matched B/E
    with open(args.trace_out, "w") as f:
        f.write(trace)
    out["trace_events"] = len(events)
    print(f"    Chrome trace: {len(events)} events -> {args.trace_out} "
          f"(open in Perfetto / chrome://tracing)")
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
