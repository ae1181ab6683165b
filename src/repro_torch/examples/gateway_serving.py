"""Continuous-batching licensed gateway on the port, end to end against a
LicenseServer.

The Fig. 2 deployment with the gateway as the serving pod:

1. publish a smoke-scale LM to the versioned WeightStore and register
   two license tiers in the accuracy table;
2. boot a ``LicensedGateway`` from the server (full snapshot over the
   §3.1.2 delta protocol, applied with the ``delta_apply`` kernel on the
   card);
3. stream mixed-tier requests with heterogeneous decode lengths — the
   scheduler forms tier-homogeneous micro-batches over the shared
   **block-paged** cache pool (oversubscribed here: 8 lanes of up to 7
   blocks each on a 36-block pool, so admission is bounded by blocks
   and the youngest request is preempted/requeued if decode growth
   exhausts them), and masked weight views are built once per
   (tier, version); on the card the kernel-resident decode runs
   ``paged_attention`` and ``paged_decode_write``;
4. serve a shared-system-prompt round through the **prefix cache**: the
   first wave donates its prompt-block chains to the (tier, version)
   radix tree, follow-up waves adopt the shared prefix by reference and
   prefill only their user-specific suffix;
5. publish a server-side weight update mid-service and stage it in
   (``begin_sync``; each stage step one ``delta_apply_parts`` launch on
   the card): new admissions pin the new version, stale views (and
   cached prefix scopes) are invalidated once the old version drains.

Run:  PYTHONPATH=src python -m repro_torch.examples.gateway_serving [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import tree_map
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.examples import check, launches, parse, parser
from repro_torch.models import init_params
from repro_torch.serving import LicensedGateway

STREAM = (("full", 8), ("free", 4), ("pro", 12), ("free", 8),
          ("full", 4), ("pro", 6), ("free", 12), ("full", 6))


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    out = {}

    # 1. cloud side: versioned store + tier ladder ---------------------------
    store = WeightStore(":memory:", row_limit=2048)   # chunk mode for LM layers
    server = LicenseServer(store)
    server.publish("lm", params, tag="v1.0")
    for name, hi in (("pro", 0.002), ("free", 0.004)):
        server.publish_tier("lm", LicenseTier(name=name,
                                              masks={"*": ((0.0, hi),)}))
    out["version"] = store.production_version("lm")
    out["tiers"] = [t for t, _ in store.list_tiers("lm")]
    print(f"[1] published 'lm' v{out['version']} with tiers {out['tiers']}")

    # 2. serving pod: gateway boots from the server --------------------------
    template = tree_map(torch.zeros_like, params)
    # max_prompt=10 is deliberately not block-aligned: shared prompt
    # chains end in a partial tail block, so the prefix demo below also
    # exercises decode's copy-on-write
    gw = LicensedGateway.from_server(cfg, server, "lm", template,
                                     max_batch=4, max_prompt=10,
                                     max_new_cap=16, block_size=4,
                                     max_lanes=8, num_blocks=36,
                                     watermark_blocks=1, device=args.device)
    out["pool"] = pool = gw.pool.stats()
    out["boot_version"], out["max_batch"] = gw.version, gw.max_batch
    print(f"[2] gateway online at weight version {gw.version}; paged pool: "
          f"{pool['num_blocks']} blocks x {pool['block_size']} tokens for "
          f"{pool['num_lanes']} lanes (vmap width {gw.max_batch})")

    # 3. mixed-tier request stream ------------------------------------------
    reqs = [gw.submit(rng.integers(0, cfg.vocab_size, 8, dtype=np.int32),
                      license=lic, max_new_tokens=n)
            for lic, n in STREAM]
    t0 = time.perf_counter()
    gw.run()
    dt = time.perf_counter() - t0
    m = gw.metrics()
    out["stream"] = {k: m[k] for k in ("completed", "tokens_generated", "decode_steps",
                                       "prefill_batches", "max_running",
                                       "max_blocks_in_use", "preempted")}
    out["stream"]["view_hits"] = m["view_cache"]["hits"]
    out["stream"]["view_misses"] = m["view_cache"]["misses"]
    out["stream"]["out_tokens"] = [len(r.out_tokens) for r in reqs]
    out["stream"]["seconds"] = dt
    out["decode_path"] = m["decode_path"]
    print(f"[3] served {m['completed']} mixed-tier requests "
          f"({m['tokens_generated']} tokens) in {dt:.2f}s — "
          f"{m['decode_steps']} decode steps, {m['prefill_batches']} prefills; "
          f"view cache {m['view_cache']['hits']} hits / "
          f"{m['view_cache']['misses']} misses; "
          f"peak {m['max_running']} concurrent on "
          f"{m['max_blocks_in_use']} blocks, {m['preempted']} preempted")
    for r in reqs[:3]:
        print(f"    [{r.license:4s} v{r.version}] {r.out_tokens}")
    check(all(len(r.out_tokens) == n for r, (_, n) in zip(reqs, STREAM)),
          "a request of the mixed-tier stream did not complete its tokens")

    # 4. shared-system-prompt round: prefix-cache reuse ----------------------
    system = rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
    convo = None
    lane0 = gw.stats["prefill_lane_tokens"]
    n = 0
    for wave in range(3):          # wave 0 populates, waves 1-2 hit
        for _ in range(3):
            user = rng.integers(0, cfg.vocab_size, 4, dtype=np.int32)
            prompt = np.concatenate([system, user])
            convo = prompt if convo is None else convo
            gw.submit(prompt, license="free", max_new_tokens=4)
            n += 1
        if wave:                   # re-served conversation: full-prompt match
            gw.submit(convo.copy(), license="free", max_new_tokens=4)
            n += 1
        gw.run()
    pm = gw.metrics()["prefix_cache"]
    out["prefix"] = dict(hit_rate=pm["hit_rate"], reused=pm["prefix_tokens_reused"],
                         prefilled=gw.stats["prefill_lane_tokens"] - lane0,
                         cold=n * gw.max_prompt, retained=pm["retained_blocks"],
                         cow=pm["cow_copies"])
    print(f"[4] shared-system-prompt round: {pm['hit_rate']:.0%} hit rate, "
          f"{pm['prefix_tokens_reused']} prompt tokens served from cache "
          f"({gw.stats['prefill_lane_tokens'] - lane0} prefilled vs "
          f"{n * gw.max_prompt} cold), {pm['retained_blocks']} blocks "
          f"retained for future hits, {pm['cow_copies']} copy-on-writes")

    # 5. staged weight update mid-service -----------------------------------
    # publish v1.1 while requests decode: begin_sync() stages the delta in
    # bounded steps riding along with the scheduler; the in-flight request
    # stays pinned to the old version across the atomic flip
    newp = tree_map(lambda x: x * 1.01, params)
    server.publish("lm", newp, tag="v1.1")
    old = gw.submit(rng.integers(0, cfg.vocab_size, 8, dtype=np.int32),
                    license="free", max_new_tokens=8)
    gw.step()                                  # old is in flight
    gw.begin_sync(max_step_bytes=2 << 20)      # pace the flip to land
                                               # while old still decodes
    gw.run()                                   # decode + staging interleave
    r = gw.submit(rng.integers(0, cfg.vocab_size, 8, dtype=np.int32),
                  license="free", max_new_tokens=4)
    gw.run()
    st = gw.metrics()["staged_update"]
    out["update"] = dict(version=gw.version, steps=st["steps"],
                         bytes_applied=st["bytes_applied"],
                         views_prewarmed=st["views_prewarmed"], old_version=old.version,
                         new_version=r.version, scopes=gw.prefix.stats()["scopes"])
    print(f"[5] staged sync to v{gw.version} in {st['steps']} bounded steps "
          f"({st['bytes_applied']} delta bytes, {st['views_prewarmed']} view "
          f"prewarmed); in-flight request stayed pinned to v{old.version}, "
          f"new request pinned to v{r.version}, "
          f"prefix scopes live: {gw.prefix.stats()['scopes']}")
    check(r.version == gw.version != old.version,
          f"after the flip the gateway serves v{r.version}, pinned v{old.version}")
    store.close()
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
