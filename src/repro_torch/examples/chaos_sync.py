"""Fault-tolerant cloud sync on the port: a staged weight update over a
hostile wire, plus license-lease degraded serving.

Walks the two failure domains end to end:

1. boot a licensed gateway against an in-memory LicenseServer and put
   requests in flight;
2. publish v2 and carry it in with a *staged* sync routed through a
   ``ChaosTransport`` — 30% of wire calls time out, disconnect
   mid-stream, or corrupt a page, and deliveries may duplicate.  The
   retry policy and chunk-granular cursor resume absorb every fault;
   decode never stops, the flip lands exactly once, and the in-flight
   requests finish pinned to v1 with the same tokens a clean wire
   would have produced;
3. freeze time and take the server away: watch the license lease walk
   HEALTHY → DEGRADED (granted tiers keep serving, new grants are
   refused) → OFFLINE (admissions rejected) → restored by the
   self-heal probe once the server returns.

Run:  PYTHONPATH=src python -m repro_torch.examples.chaos_sync [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import tree_map
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.transport import (ChaosTransport, DirectTransport, RetryPolicy,
                                        TransportTimeout)
from repro_torch.core.weightstore import WeightStore
from repro_torch.examples import check, launches, parse, parser
from repro_torch.models import init_params
from repro_torch.serving import LicensedGateway, RequestState


class FlakyTransport(DirectTransport):
    """Direct delivery with a kill switch — the 'server unreachable'
    condition for the lease demo."""

    def __init__(self, server):
        super().__init__(server)
        self.down = False

    def _call(self, op, thunk):
        if self.down:
            raise TransportTimeout(f"{op}: server unreachable")
        return super()._call(op, thunk)


def _server(params):
    store = WeightStore(":memory:", row_limit=2048)
    server = LicenseServer(store)
    server.publish("lm", params, tag="v1")
    server.publish_tier("lm", LicenseTier(name="free",
                                          masks={"*": ((0.0, 0.004),)}))
    return server


def _boot(cfg, server, params, device, **kw):
    template = tree_map(torch.zeros_like, params)
    return LicensedGateway.from_server(cfg, server, "lm", template,
                                       max_batch=2, max_prompt=8,
                                       max_new_cap=16, device=device, **kw)


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 500, 8, dtype=np.int32)


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = init_params(cfg, seed=0, device=args.device)
    out = {}

    # ---- 1. staged sync through a 30%-fault wire --------------------------
    server = _server(params)
    gw = _boot(cfg, server, params, args.device)
    a = gw.submit(_prompt(1), license="free", max_new_tokens=12)
    b = gw.submit(_prompt(2), license="free", max_new_tokens=12)
    gw.step()                                 # a, b mid-decode
    server.publish("lm", tree_map(lambda x: x * 1.01, params), tag="v2")

    chaos = ChaosTransport(server, seed=7, fault_rate=0.3, dup_rate=0.15,
                           sleep=lambda _s: None)
    retry = RetryPolicy(max_attempts=10, base_delay_s=0.0, jitter=0.0,
                        sleep=lambda _s: None)
    check(gw.begin_sync(transport=chaos, retry=retry, max_step_bytes=24 << 10),
          "begin_sync found no update to stage")
    while gw.sync_active or gw.scheduler.waiting or gw.scheduler.running:
        gw.step()                             # decode interleaves the sync
    check(a.state == b.state == RequestState.DONE,
          f"the in-flight requests ended {a.state} / {b.state}, not DONE")

    st = gw.metrics()["staged_update"]
    wire = st["wire"]
    out["sync"] = dict(version=gw.version, retries=st["retries"], resumes=st["resumes"],
                       flips=st["flips"],
                       audit_flips=len(gw.audit.events("version_flip")),
                       audit_retries=len(gw.audit.events("sync_retry")),
                       pinned=a.version, out_tokens=[len(a.out_tokens), len(b.out_tokens)],
                       **{k: wire[k] for k in ("faults", "calls", "timeouts", "disconnects",
                                               "corruptions", "duplicates")})
    print(f"sync landed at v{gw.version} through "
          f"{wire['faults']}/{wire['calls']} faulted wire calls "
          f"(timeouts={wire['timeouts']} disconnects={wire['disconnects']} "
          f"corruptions={wire['corruptions']} dups={wire['duplicates']})")
    print(f"  retries={st['retries']} cursor-resumes={st['resumes']} "
          f"flips={st['flips']} (audit: "
          f"{len(gw.audit.events('version_flip'))} version_flip, "
          f"{len(gw.audit.events('sync_retry'))} sync_retry)")
    print(f"  in-flight requests finished pinned to v{a.version} — "
          f"faults changed counters, never tokens")

    # ---- 2. license-lease degraded serving --------------------------------
    now = [0.0]
    server2 = _server(params)
    tr = FlakyTransport(server2)
    gw2 = _boot(cfg, server2, params, args.device, transport=tr, clock=lambda: now[0],
                lease_ttl_s=10.0, lease_grace_s=20.0,
                retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.0,
                                         sleep=lambda _s: None))
    warm = gw2.submit(_prompt(0), license="free", max_new_tokens=2)
    gw2.run()
    check(warm.state == RequestState.DONE, f"the warm-up request ended {warm.state}")

    tr.down = True                            # server goes dark
    now[0] = 11.0                             # past the TTL
    gw2.step()
    ok = gw2.submit(_prompt(3), license="free", max_new_tokens=2)
    gw2.run()
    server2.publish_tier("lm", LicenseTier(name="pro",
                                           masks={"*": ((0.0, 0.002),)}))
    rej = gw2.submit(_prompt(4), license="pro", max_new_tokens=2)
    degraded = gw2.metrics()["lease"]["state"]
    print(f"\nlease @t=11s: {degraded} — "
          f"granted tier served ({ok.state.name}), "
          f"new tier grant refused ({rej.state.name})")

    now[0] = 35.0                             # past TTL + grace
    gw2.step()
    rej2 = gw2.submit(_prompt(5), license="free", max_new_tokens=2)
    offline = gw2.metrics()["lease"]["state"]
    print(f"lease @t=35s: {offline} — "
          f"admission {rej2.state.name}: {rej2.error}")

    tr.down = False                           # server returns
    now[0] = 37.0
    gw2.step()                                # self-heal probe fires
    lease = gw2.metrics()["lease"]
    back = gw2.submit(_prompt(6), license="pro", max_new_tokens=2)
    gw2.run()
    print(f"lease @t=37s: {lease['state']} after "
          f"{lease['degraded_seconds_total']:.0f}s degraded — deferred "
          f"'pro' grant now serves ({back.state.name})")
    out["lease"] = dict(t11=degraded, t11_served=ok.state.name, t11_refused=rej.state.name,
                        t35=offline, t35_admission=rej2.state.name, t35_error=rej2.error,
                        t37=lease["state"], degraded_s=lease["degraded_seconds_total"],
                        t37_served=back.state.name)
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
