"""The port's shared-prefix radix cache against the JAX package, on the CPU.

Two levels:

* the radix tree alone: the same operation sequences go through
  ``repro.serving.prefix.PrefixCache`` and ``repro_torch.serving.prefix.
  PrefixCache``, each over its own package's ``BlockAllocator``, with
  ``debug = True`` (every eviction re-derives the evictable set from a
  full walk).  Every result, refcount, eviction order and ``stats()``
  must be identical;
* the gateway: ``repro.serving.LicensedGateway(prefix_cache=True,
  telemetry=False)`` and the port's default gateway serve one
  shared-prefix stream (prompts off block multiples, exact repeats, a
  1-token prompt) on the same weights, in float and int8-view modes, on
  a pool small enough to force eviction and preemption and on a fully
  provisioned one (where a shared tail's first decode write takes the
  tree's reference back, ``forget_block``).  Greedy tokens, the schedule
  trace and every prefix, CoW, eviction and preemption counter must be
  identical.

Then the port alone: (tier, version) isolation across ``update_weights``
and a tier redefinition, a hit stream against its own cold stream, and
(marked ``gpu``) the same on the card through the decode kernels.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.paging import BlockAllocator as JaxBlockAllocator
from repro.serving.prefix import PrefixCache as JaxPrefixCache

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models.model import params_from_jax
from repro_torch.serving import (BlockAllocator, LicensedGateway, PrefixCache,
                                 RequestState)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = {"jax": (JaxPrefixCache, JaxBlockAllocator),
            "torch": (PrefixCache, BlockAllocator)}


def _release(pc, blocks):
    """Release request references the way the gateway does: decref plus
    the note_release() hook that keeps the reclaimable counter exact."""
    for b in blocks:
        if pc.allocator.decref(b) == 1:
            pc.note_release(b)


def _state(pc):
    """Everything observable: stats, refcounts, the evictable order."""
    a = pc.allocator
    return (pc.stats(), pc.reclaimable(), pc.epoch, a.stats(),
            sorted((b, a.refcount(b)) for b in a._ref), list(pc._evictable))


# ------------------------------------------------------ radix-tree scenarios
def _match_insert_refcounts(cache, alloc, log):
    a = alloc(16)
    pc = cache(a, block_size=4)
    pc.debug = True
    toks = list(range(10))                       # 2 full blocks + fill-2 tail
    blocks = a.alloc(3)
    log(pc.match("s", toks), pc.insert("s", toks, blocks), _state(pc))
    _release(pc, blocks)
    log(pc.match("s", toks), pc.match("s", toks[:8] + [99, 98]),
        pc.match("s", [77] + toks[1:]), pc.match("s", toks[:9]), _state(pc))
    return pc


def _insert_keeps_first(cache, alloc, log):
    a = alloc(8)
    pc = cache(a, block_size=4)
    pc.debug = True
    toks = list(range(8))
    first, second = a.alloc(2), a.alloc(2)
    log(pc.insert("s", toks, first), pc.insert("s", toks, second),
        a.refcount(second[0]))
    a.free(second)
    log(pc.match("s", toks), _state(pc))
    return pc


def _lru_leaf_first(cache, alloc, log):
    a = alloc(16)
    pc = cache(a, block_size=4)
    pc.debug = True
    chains = {}
    for s in range(3):
        toks = [100 * s + i for i in range(8)]
        blocks = a.alloc(2)
        pc.insert("s", toks, blocks)
        _release(pc, blocks)
        chains[s] = (toks, blocks)
    pc.match("s", chains[0][0])
    _release(pc, chains[0][1])
    log(pc.evict(2), _state(pc), pc.match("s", chains[1][0]),
        pc.match("s", chains[0][0]))
    log(pc.evict(10), pc.match("s", chains[0][0]), _state(pc))
    return pc


def _chain_promotion(cache, alloc, log):
    a = alloc(16)
    pc = cache(a, block_size=4)
    pc.debug = True
    chains = {}
    for s in range(3):
        toks = [100 * s + i for i in range(8)]
        blocks = a.alloc(2)
        pc.insert("s", toks, blocks)
        chains[s] = (toks, blocks)
    for s in (1, 2, 0):
        _release(pc, chains[s][1])
    log(_state(pc), pc.evict(2), pc.match("s", chains[1][0]),
        pc.match("s", chains[2][0]))
    _release(pc, chains[2][1])
    pc.insert("s", chains[2][0], chains[2][1])
    log(_state(pc), pc.evict(2), pc.match("s", chains[0][0]),
        pc.match("s", chains[2][0]), _state(pc))
    # a diverging match keeps a shared prefix hot: once its stale
    # branch drains, the prefix keeps its recency at the back
    base = [7, 7, 7, 7]
    first = a.alloc(2)
    pc.insert("s", base + [1, 1, 1, 1], first)
    _release(pc, first)
    adopted, _ = pc.match("s", base + [2, 2, 2, 2])
    fresh = a.alloc(1)
    pc.insert("s", base + [2, 2, 2, 2], adopted + fresh)
    _release(pc, adopted + fresh)
    adopted, _ = pc.match("s", base + [3, 3, 3, 3])
    _release(pc, adopted)
    log(_state(pc), pc.evict(1), _state(pc), pc.evict(3), _state(pc))
    return pc


def _evict_one_without_walk(cache, alloc, log):
    a = alloc(64)
    pc = cache(a, block_size=4)
    pc.debug = True
    for s in range(10):
        toks = [100 * s + i for i in range(8)]
        blocks = a.alloc(2)
        pc.insert("s", toks, blocks)
        _release(pc, blocks)
    log(pc.evict(1), _state(pc))
    pc._check()
    return pc


def _scope_isolation_and_drop(cache, alloc, log):
    a = alloc(8)
    pc = cache(a, block_size=4)
    pc.debug = True
    toks = list(range(8))
    blocks = a.alloc(2)
    pc.insert(("free", 1), toks, blocks)
    _release(pc, blocks)
    other = a.alloc(2)
    pc.insert(("pro", 1), toks, other)
    log(pc.match(("pro", 2), toks), pc.match(("free", 2), toks),
        pc.match(("free", 1), toks), _state(pc))
    _release(pc, blocks)
    # pro's chain is still request-held: its blocks outlive the drop
    log(pc.drop_scope(tier="pro"), _state(pc))
    _release(pc, other)
    log(pc.drop_scope(version=1), pc.match(("free", 1), toks), _state(pc))
    return pc


def _forget_block(cache, alloc, log):
    a = alloc(8)
    pc = cache(a, block_size=4)
    pc.debug = True
    toks = list(range(6))                        # full block + fill-2 tail
    blocks = a.alloc(2)
    pc.insert("s", toks, blocks)
    # interior nodes are refused, a leaf held by its request is dropped
    log(pc.forget_block(blocks[0]), pc.forget_block(blocks[1]),
        pc.forget_block(blocks[1]), pc.forget_block(99), _state(pc))
    _release(pc, blocks)
    # a tree-only leaf: forgetting it frees the block and promotes its parent
    more = a.alloc(1)
    pc.insert("s", toks[:4] + [9, 9], [blocks[0], more[0]])
    _release(pc, more)
    log(_state(pc), pc.forget_block(more[0]), _state(pc), pc.evict(4), _state(pc))
    return pc


def _peek_side_effect_free(cache, alloc, log):
    a = alloc(8)
    pc = cache(a, block_size=4)
    pc.debug = True
    toks = list(range(8))
    blocks = a.alloc(2)
    pc.insert("s", toks, blocks)
    _release(pc, blocks)
    before = _state(pc)
    log(pc.peek("s", toks), pc.peek("s", toks[:4] + [9, 9, 9, 9]),
        pc.peek("s", [9] * 8), pc.peek("other", toks))
    assert _state(pc) == before
    return pc


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _match_insert_refcounts, _insert_keeps_first, _lru_leaf_first, _chain_promotion,
    _evict_one_without_walk, _scope_isolation_and_drop, _forget_block,
    _peek_side_effect_free)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_radix_tree_matches_jax(name):
    logs = {}
    for pkg, (cache, alloc) in PACKAGES.items():
        got = []
        pc = SCENARIOS[name](cache, alloc, lambda *xs: got.append(xs))
        pc._check()
        got.append(_state(pc))
        logs[pkg] = got
    assert logs["torch"] == logs["jax"]


# ---------------------------------------------------------------- gateways
FREE = {"*": ((0.0, 0.01),)}
PRO = {"*": ((0.0, 0.005),)}
SMALL = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
             block_size=4, num_blocks=8)
FULL = dict(max_batch=2, max_prompt=8, max_new_cap=8, block_size=16)


def _shared_stream(seed=0, n=8, head=8):
    """(tier, prompt) pairs: one system prefix of ``head`` tokens and an
    own suffix of 1-3 tokens each (prompts off block multiples), exact
    repeats of earlier prompts, and a 1-token prompt."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, 500, head, dtype=np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, 500, 1 + i % 3, dtype=np.int32)
        out.append(("free" if i % 2 else "full", np.concatenate([sys_prompt, tail])))
    out += [out[1], out[2], out[1]]
    out.append(("full", np.asarray([7], np.int32)))
    out.append(("full", np.asarray([7], np.int32)))
    return out


def _distinct_stream(seed=20, n=4, length=8):
    rng = np.random.default_rng(seed)
    return [("full", rng.integers(0, 500, length, dtype=np.int32)) for _ in range(n)]


def _drain(gw, stream, waves=2, max_new=5):
    """Submit ``stream`` in ``waves`` rounds, draining between rounds so
    later rounds see the populated cache."""
    reqs, per = [], -(-len(stream) // waves)
    for w in range(waves):
        reqs += [gw.submit(p, license=t, max_new_tokens=max_new - i % 2)
                 for i, (t, p) in enumerate(stream[w * per:(w + 1) * per])]
        gw.run()
    assert all(r.state.value == RequestState.DONE.value for r in reqs), \
        [r.error for r in reqs]
    return reqs


def _counters(gw):
    m = gw.metrics()
    return dict(trace=list(gw.trace), prefix_cache=m["prefix_cache"],
                **{k: gw.stats[k] for k in (
                    "prefix_tokens_reused", "cow_copies", "preempted",
                    "max_blocks_in_use", "prefill_lane_tokens", "prefill_chunks",
                    "decode_steps", "tokens_generated", "completed")})


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _pair(weights, geometry, mode):
    jcfg, jparams, cfg, params = weights
    kw = dict(geometry, **({} if mode == "float"
                           else dict(quantized=True, materialize_int8_views=True)))
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     prefix_cache=True, telemetry=False, **kw)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          device="cpu", **kw)
    tgw.prefix.debug = True
    return jgw, tgw


@pytest.fixture(scope="module", params=["float", "int8"])
def small_pool(request, weights):
    jgw, tgw = _pair(weights, SMALL, request.param)
    stream = _shared_stream()
    return jgw, _drain(jgw, stream), tgw, _drain(tgw, stream)


def test_small_pool_tokens_identical(small_pool):
    jgw, jreqs, tgw, treqs = small_pool
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, (jr.rid, len(jr.prompt))
        assert tr.prefix_tokens == jr.prefix_tokens, jr.rid


def test_small_pool_counters_identical(small_pool):
    jgw, _, tgw, _ = small_pool
    got, want = _counters(tgw), _counters(jgw)
    assert got == want
    # the stream exercised every path: hits, CoW, eviction, preemption
    assert got["prefix_tokens_reused"] > 0 and got["cow_copies"] > 0
    assert got["preempted"] > 0 and got["prefix_cache"]["evicted_blocks"] > 0
    assert got["prefix_cache"]["hits"] > 0


def test_small_pool_drains_to_tree_references(small_pool):
    """After the drain only the tree holds blocks, and the O(1)
    reclaimable counter and evictable set match a full recount."""
    _, _, tgw, _ = small_pool
    st = tgw.metrics()["prefix_cache"]
    alloc = tgw.pool.allocator
    assert alloc.num_held == st["retained_blocks"] == st["cached_blocks"]
    assert alloc.num_free + alloc.num_held == tgw.pool.num_blocks
    tgw.prefix._check()


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_fully_provisioned_pool_takes_tree_reference_back(weights, mode):
    """No spare block: a donated tail's first decode write takes the
    tree's reference back (``forget_block``) instead of a CoW copy or a
    preemption — as in the JAX gateway."""
    jgw, tgw = _pair(weights, FULL, mode)
    stream = _distinct_stream()
    jreqs, treqs = _drain(jgw, stream, waves=1), _drain(tgw, stream, waves=1)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    got = _counters(tgw)
    assert got == _counters(jgw)
    assert got["preempted"] == 0 and got["cow_copies"] == 0
    assert got["prefix_cache"]["evicted_blocks"] > 0


def test_hit_stream_equals_cold_stream(weights):
    """The port's hit stream gives the same greedy tokens as its own
    prefix-free stream, with fewer prefill lane-tokens."""
    _, _, cfg, params = weights
    runs = {}
    for on in (True, False):
        gw = LicensedGateway(cfg, params, device="cpu", prefix_cache=on,
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             **dict(SMALL, num_blocks=15))
        runs[on] = (gw, _drain(gw, _shared_stream(seed=3)))
    (hot, hreqs), (cold, creqs) = runs[True], runs[False]
    assert [r.out_tokens for r in hreqs] == [r.out_tokens for r in creqs]
    assert hot.stats["prefix_tokens_reused"] > 0 and hot.stats["cow_copies"] > 0
    assert hot.stats["prefill_lane_tokens"] < cold.stats["prefill_lane_tokens"]
    assert cold.metrics()["prefix_cache"] == {"enabled": False}
    assert cold.pool.allocator.num_held == 0


def _isolation_log(gw, params, tier_cls, scale):
    """Serve one prompt across tiers, a weight update and a redefinition
    of ``free``; log the cache's stats after each step."""
    prompt = np.random.default_rng(9).integers(0, 500, 10, dtype=np.int32)
    log = []

    def serve(tier):
        r = gw.submit(prompt, license=tier, max_new_tokens=3)
        gw.run()
        st = gw.prefix.stats()
        log.append((tier, gw.version, r.prefix_tokens, r.out_tokens, st["hits"],
                    st["scopes"], st["dropped_blocks"],
                    sorted(map(str, gw.prefix._scopes))))

    serve("free")
    serve("pro")                     # same tokens, other tier: no hit
    serve("free")                    # same tier: hit
    gw.update_weights(scale(params))
    serve("free")                    # new version: no hit; v1's scopes gone
    assert all(s[1] == gw.version for s in gw.prefix._scopes)
    gw._pending_tiers["free"] = tier_cls(name="free", masks=PRO)
    gw._apply_pending_tiers()        # a redefinition drops the tier's scope
    log.append(("redefined", gw.prefix.stats()["dropped_blocks"],
                sorted(map(str, gw.prefix._scopes))))
    serve("free")                    # the new masks: no hit
    serve("free")
    return log


def test_tier_and_version_isolation_matches_jax(weights):
    jcfg, jparams, cfg, params = weights
    geo = dict(SMALL, num_blocks=15)
    jgw = JaxGateway(jcfg, jparams, prefix_cache=True, telemetry=False,
                     tiers={"free": JaxLicenseTier(name="free", masks=FREE),
                            "pro": JaxLicenseTier(name="pro", masks=PRO)}, **geo)
    tgw = LicensedGateway(cfg, params, device="cpu",
                          tiers={"free": LicenseTier(name="free", masks=FREE),
                                 "pro": LicenseTier(name="pro", masks=PRO)}, **geo)
    tgw.prefix.debug = True
    want = _isolation_log(jgw, jparams, JaxLicenseTier,
                          lambda p: jax.tree_util.tree_map(lambda x: x * 1.01, p))
    got = _isolation_log(tgw, params, LicenseTier, _scaled)
    assert got == want
    hits = [e[2] for e in got if e[0] != "redefined"]
    assert hits == [0, 0, 9, 0, 0, 9]


def _scaled(tree):
    return {k: (v * 1.01 if isinstance(v, torch.Tensor) else _scaled(v))
            for k, v in tree.items()}


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_hit_stream_equals_cold_stream_on_card(weights, cuda):
    """The shared-prefix stream through the decode kernels: the hit
    stream's greedy tokens equal the cold stream's (f32 smoke weights)."""
    _, _, cfg, params = weights
    dev_params = _to(params, cuda)
    runs = {}
    for on in (True, False):
        gw = LicensedGateway(cfg, dev_params, device=cuda, prefix_cache=on,
                             decode_kernels=True,
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             **SMALL)
        runs[on] = (gw, _drain(gw, _shared_stream(seed=3)))
    (hot, hreqs), (_, creqs) = runs[True], runs[False]
    assert [r.out_tokens for r in hreqs] == [r.out_tokens for r in creqs]
    assert hot.stats["prefix_tokens_reused"] > 0 and hot.stats["cow_copies"] > 0


def _to(tree, device):
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else _to(v, device))
            for k, v in tree.items()}
