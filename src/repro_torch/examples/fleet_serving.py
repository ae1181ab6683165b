"""Multi-model, multi-tenant fleet serving behind one gateway loop, on the
port.

The consolidation deployment the paper's licensing model points at:
several licensed model products served from ONE edge binary, each
tenant's contract encoded as (model, tier) entitlements plus quotas —
not one process per model.

1. build three heterogeneous smoke models (GQA transformer, pure-SSM,
   sliding-window hybrid) and register them as fleet slots under one
   global cache-byte budget;
2. register two tenants: "acme" (entitled to two models, rate-limited)
   and "hobby" (free tier of one model, concurrency-capped at 1);
3. stream mixed requests — the fleet round-robins (model, tier,
   version)-homogeneous micro-batches across slots, debiting one shared
   byte budget, while quota rejections come back instantly at submit;
4. revoke "acme"'s entitlement mid-flight: the decoding request drains
   to completion, the queued one is rejected at batch formation;
5. print the three-section metrics: fleet totals, per-model, per-tenant.

On the card the GQA slot's kernel-resident decode runs ``paged_attention``
and ``paged_decode_write``.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_serving [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.examples import launches, parse, parser
from repro_torch.models import init_params
from repro_torch.serving import FleetGateway, TenantRegistry

MODELS = ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-2b")
TIERS = {"free": LicenseTier(name="free", masks={"*": ((0.0, 0.004),)})}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    rng = np.random.default_rng(0)
    out = {}

    # 1. three heterogeneous slots under one budget --------------------------
    tenants = TenantRegistry()
    fleet = FleetGateway(cache_budget_bytes=1 << 20, tenants=tenants)
    for i, name in enumerate(MODELS):
        cfg = smoke_variant(get_config(name))
        params = init_params(cfg, seed=i, device=args.device)
        # the qwen slot gets ONE lane so step [4] below can show a
        # request still queued when its entitlement is revoked
        fleet.add_model(name, cfg, params, tiers=dict(TIERS),
                        max_batch=1 if name == "qwen2.5-3b" else 2,
                        max_prompt=8, max_new_cap=8, device=args.device)
    paged = [n for n, g in fleet.gateways.items() if g.paged]
    out["models"], out["paged"] = len(fleet.gateways), paged
    print(f"[1] fleet online: {len(fleet.gateways)} models "
          f"({', '.join(MODELS)}); {len(paged)} paged slots share a "
          f"{fleet.cache_budget_bytes >> 10} KiB cache budget "
          f"(the pure-SSM slot's constant-size lane state sits outside it)")

    # 2. tenant contracts ----------------------------------------------------
    tenants.register("acme",
                     entitlements=("qwen2.5-3b:*", "recurrentgemma-2b:*"),
                     rate=50.0, burst=8)
    tenants.register("hobby", entitlements=("mamba2-130m:free",),
                     max_concurrent=1)
    print("[2] tenants: acme (2 models, 50 req/s, burst 8) | "
          "hobby (mamba2 free tier, 1 concurrent)")

    # 3. mixed stream: routing, quotas, shared budget ------------------------
    def prompt():
        return rng.integers(0, 500, 8, dtype=np.int32)

    reqs = [
        fleet.submit("qwen2.5-3b", prompt(), tenant="acme",
                     license="full", max_new_tokens=6),
        fleet.submit("recurrentgemma-2b", prompt(), tenant="acme",
                     license="free", max_new_tokens=4),
        fleet.submit("mamba2-130m", prompt(), tenant="hobby",
                     license="free", max_new_tokens=6),
        # hobby is at its concurrency cap -> instant rejection
        fleet.submit("mamba2-130m", prompt(), tenant="hobby",
                     license="free", max_new_tokens=4),
        # hobby holds no qwen entitlement -> instant rejection
        fleet.submit("qwen2.5-3b", prompt(), tenant="hobby",
                     license="free", max_new_tokens=4),
    ]
    t0 = time.perf_counter()
    done = fleet.run()
    dt = time.perf_counter() - t0
    out["drained"], out["rejected"] = len(done), [r.error for r in reqs if r.error]
    out["out_tokens"] = [len(r.out_tokens) for r in reqs]
    print(f"[3] drained {len(done)} requests in {dt:.2f}s; rejected at "
          f"submit: {[r.error for r in reqs if r.error][:2]}")

    # 4. mid-flight revocation: drain, never cancel --------------------------
    r_live = fleet.submit("qwen2.5-3b", prompt(), tenant="acme",
                          license="full", max_new_tokens=8)
    r_queued = fleet.submit("qwen2.5-3b", prompt(), tenant="acme",
                            license="full", max_new_tokens=8)
    while r_live.state.value != "running":      # step until r_live decodes
        fleet.step()
    tenants.revoke("acme", "qwen2.5-3b", "full")
    fleet.run()
    out["revoked"] = dict(live=r_live.state.value, live_tokens=len(r_live.out_tokens),
                          queued=r_queued.state.value, queued_error=r_queued.error)
    print(f"[4] revoked acme's (qwen2.5-3b, full) mid-flight: decoding "
          f"request {r_live.state.value} with {len(r_live.out_tokens)} "
          f"tokens, queued request {r_queued.state.value} "
          f"({r_queued.error})")

    # 5. three-section metrics ----------------------------------------------
    m = fleet.metrics()
    f = m["fleet"]
    out["fleet"] = {k: f[k] for k in ("completed", "quota_rejections", "models", "steps",
                                      "cache_used_bytes", "cache_budget_bytes")}
    print(f"[5] fleet: {f['completed']} completed / "
          f"{f['quota_rejections']} quota-rejected across {f['models']} "
          f"models in {f['steps']} steps; cache "
          f"{f['cache_used_bytes']}/{f['cache_budget_bytes']} bytes used")
    out["per_model"], out["tenants"] = {}, {}
    for name, mm in m["models"].items():
        # 'held' is block-pool geometry: the contiguous-fallback (SSM)
        # slot's cache_pool has lane occupancy instead
        out["per_model"][name] = dict(tokens=mm["tokens_generated"],
                                      completed=mm["completed"],
                                      held=mm["cache_pool"].get("held", 0))
        print(f"    {name:18s} {mm['tokens_generated']:3d} tokens, "
              f"{mm['completed']} done, blocks held: "
              f"{mm['cache_pool'].get('held', 0)}")
    for name, t in m["tenants"].items():
        out["tenants"][name] = {k: t[k] for k in ("admitted", "submitted", "completed",
                                                  "quota_rejections", "entitlements")}
        print(f"    tenant {name:6s} {t['admitted']}/{t['submitted']} "
              f"admitted, {t['completed']} done, "
              f"{t['quota_rejections']} quota-rejected, "
              f"entitlements {t['entitlements']}")
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
