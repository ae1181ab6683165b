"""The gateway's fallbacks in the port against the JAX package, on the CPU.

The JAX gateway routes onto these paths by explicit arguments, and the
port takes the same ones:

* ``kernel_decode=False``: the gather/scatter decode (each lane's logical
  cache gathered from the paged pool, decoded by ``serve_step`` and
  scattered back);
* ``paged=False``: the contiguous ``CachePool`` (bucket prefill and
  gather/scatter decode, no prefix cache);
* ``chunk_size=0``: the bucket prefill (prompts right-aligned into the
  ``max_prompt`` bucket with repeated-first-token padding), with the
  prefix cache's suffix prefill and suffix-width admission groups, and
  without the cache;
* ``decode_pallas="off"``: the JAX slot's name for the plain decode path.

Each runs one stream through ``repro.serving.LicensedGateway`` and the
port's gateway on the same weights (``params_from_jax``); the JAX run of
a case is shared through a module fixture.  Greedy tokens, the action
trace, the stats counters and the ``cache_pool`` / ``decode_path`` /
``chunked_prefill`` / ``admission_grouping`` / ``prefix_cache`` sections
of ``metrics()`` must be identical (the port's ``decode_path.kernels``
aside).  Then a ``FleetGateway`` with one contiguous slot beside a paged
one under a byte budget, the engine functions one by one, the default
gateway on a squared-ReLU config, and the argument checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import FleetGateway as JaxFleetGateway
from repro.serving import LicensedGateway as JaxGateway
from repro.serving import engine as jax_engine

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models.model import params_from_jax
from repro_torch.serving import FleetGateway, LicensedGateway, RequestState
from repro_torch.serving import engine
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREE = {"*": ((0.0, 0.01),)}
# a small pool (block_size 4): eviction and preemption happen
SMALL = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
             block_size=4, num_blocks=8)
# mixed tiers, prompt lengths off block multiples
MIXED = [("full", 7), ("free", 5), ("full", 11), ("free", 9), ("full", 3), ("free", 10)]


def _prompt(i, n):
    return np.random.default_rng(100 + i).integers(0, 500, n, dtype=np.int32)


def _mixed_stream():
    return [(tier, _prompt(i, n)) for i, (tier, n) in enumerate(MIXED)]


def _shared_stream(seed=0, n=8, head=8):
    """One system prefix of ``head`` tokens and an own suffix of 1-3
    tokens each, exact repeats of earlier prompts, and a 1-token prompt
    (as ``test_torch_prefix.py``)."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, 500, head, dtype=np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, 500, 1 + i % 3, dtype=np.int32)
        out.append(("free" if i % 2 else "full", np.concatenate([sys_prompt, tail])))
    out += [out[1], out[2], out[1]]
    out += [("full", np.asarray([7], np.int32))] * 2
    return out


# case -> (gateway arguments, stream)
CASES = {
    "kernel_decode_off": (dict(kernel_decode=False), _shared_stream),
    "kernel_decode_off_in_scan": (dict(kernel_decode=False, quantized=True), _mixed_stream),
    "contiguous_pool": (dict(paged=False), _mixed_stream),
    "contiguous_pool_int8_views": (dict(paged=False, quantized=True,
                                        materialize_int8_views=True), _mixed_stream),
    "bucket_prefill_prefix_on": (dict(chunk_size=0), _shared_stream),
    "bucket_prefill_prefix_off": (dict(chunk_size=0, prefix_cache=False), _shared_stream),
    "bucket_prefill_in_scan": (dict(chunk_size=0, quantized=True), _shared_stream),
    "decode_pallas_off": (dict(decode_pallas="off"), _shared_stream),
}
STATS = ("completed", "tokens_generated", "decode_steps", "resident_decode_steps",
         "prefill_batches", "prefill_chunks", "prefill_lane_tokens", "prefix_tokens_reused",
         "cow_copies", "preempted", "max_running", "max_blocks_in_use")
SECTIONS = ("cache_pool", "decode_path", "chunked_prefill", "admission_grouping",
            "prefix_cache")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


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


def _observed(gw):
    """Trace, counters and the metrics sections both packages report."""
    m = gw.metrics()
    sections = {k: dict(m[k]) for k in SECTIONS}
    sections["decode_path"].pop("kernels", None)          # the port's own key
    return dict(trace=list(gw.trace), stats={k: gw.stats[k] for k in STATS}, **sections)


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request, weights):
    jcfg, jparams, cfg, params = weights
    kw, stream_fn = CASES[request.param]
    stream = stream_fn()
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     telemetry=False, **SMALL, **kw)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          device="cpu", **SMALL, **kw)
    if tgw.prefix is not None:
        tgw.prefix.debug = True
    return request.param, jgw, _drain(jgw, stream), tgw, _drain(tgw, stream)


def test_fallback_tokens_identical(served):
    _, jgw, jreqs, tgw, treqs = served
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, (jr.rid, len(jr.prompt))
        assert tr.prefix_tokens == jr.prefix_tokens, jr.rid


def test_fallback_trace_counters_and_metrics_identical(served):
    case, jgw, _, tgw, _ = served
    got, want = _observed(tgw), _observed(jgw)
    assert got == want
    # each case ran the path it names
    kw = CASES[case][0]
    assert got["cache_pool"]["paged"] == kw.get("paged", True)
    assert got["decode_path"]["kernel_resident"] == (
        kw.get("kernel_decode", True) and kw.get("paged", True))
    assert got["chunked_prefill"]["enabled"] == (kw.get("chunk_size") != 0
                                                 and kw.get("paged", True))
    assert not tgw.decode_kernels and tgw._graphs is None and tgw._prefill_graphs is None
    if case == "bucket_prefill_prefix_on":
        assert got["stats"]["prefix_tokens_reused"] > 0
        assert got["admission_grouping"]["batches_by_suffix_width"]
    if case == "kernel_decode_off":
        assert got["stats"]["cow_copies"] > 0 and got["stats"]["preempted"] > 0


def test_bucket_prefill_cache_saves_lane_tokens(weights):
    """The bucket prefill's prefix cache: the same greedy tokens as with
    the cache off, fewer prefill lane-tokens, hits > 0 (the JAX gateway's
    own contract, here on the port alone)."""
    _, _, cfg, params = weights
    stream = _shared_stream()
    runs = {}
    for on in (True, False):
        gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                             device="cpu", chunk_size=0, prefix_cache=on,
                             **dict(SMALL, num_blocks=24))
        runs[on] = ([r.out_tokens for r in _drain(gw, stream)], gw.stats)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1]["prefix_tokens_reused"] > 0
    assert runs[True][1]["prefill_lane_tokens"] < runs[False][1]["prefill_lane_tokens"]


# ------------------------------------------------------------------ fleet
class Clock:
    """Hand-advanced clock: reads ``now`` and never moves on its own."""

    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


# slot -> (kwargs, stream); the contiguous slot beside a paged one
FLEET_SLOTS = {"paged": ({}, _shared_stream), "contiguous": (dict(paged=False), _mixed_stream)}


def _fleet_run(pkg, weights):
    jcfg, jparams, cfg, params = weights
    clock = Clock()
    tier = JaxLicenseTier if pkg == "jax" else LicenseTier
    fleet = (JaxFleetGateway if pkg == "jax" else FleetGateway)(clock=clock,
                                                               cache_budget_bytes=1 << 30)
    for name, (kw, _) in FLEET_SLOTS.items():
        fleet.add_model(name, jcfg if pkg == "jax" else cfg,
                        jparams if pkg == "jax" else params,
                        tiers={"free": tier(name="free", masks=FREE)},
                        **SMALL, **kw, **({} if pkg == "jax" else dict(device="cpu")))
    # the budget holds exactly one full request of the paged slot: the
    # contiguous slot is outside it
    paged = fleet.gateways["paged"]
    fleet.cache_budget_bytes = -(-paged.capacity // paged.pool.block_size) * \
        paged.pool.block_bytes
    reqs = {name: [fleet.submit(name, p, license=t, max_new_tokens=5 - i % 2)
                   for i, (t, p) in enumerate(stream())]
            for name, (_, stream) in FLEET_SLOTS.items()}
    acts, used = [], []
    for _ in range(1000):
        act = fleet.step()
        clock.now += 0.5
        used.append(fleet.used_cache_bytes())
        if act is None:
            break
        acts.append((act.model, act.kind, act.tier, act.version, len(act.requests)))
    m = fleet.metrics()
    return fleet, reqs, acts, used, m


@pytest.fixture(scope="module")
def fleets(weights):
    return {pkg: _fleet_run(pkg, weights) for pkg in ("jax", "torch")}


def test_fleet_with_a_contiguous_slot_matches_jax(fleets):
    jf, jreqs, jacts, jused, jm = fleets["jax"]
    tf, treqs, tacts, tused, tm = fleets["torch"]
    for name in FLEET_SLOTS:
        assert [r.out_tokens for r in treqs[name]] == [r.out_tokens for r in jreqs[name]]
        assert all(r.state is RequestState.DONE for r in treqs[name])
    assert tacts == jacts and tused == jused
    assert max(tused) <= tf.cache_budget_bytes
    assert tm["fleet"] == jm["fleet"]
    for name in FLEET_SLOTS:
        got = {k: dict(tm["models"][name][k]) for k in SECTIONS}
        want = {k: dict(jm["models"][name][k]) for k in SECTIONS}
        got["decode_path"].pop("kernels")
        assert got == want, name
    assert tm["models"]["contiguous"]["cache_pool"]["paged"] is False
    assert tf.gateways["contiguous"].scheduler.global_budget is None


def test_fleet_slots_equal_isolated_gateways(weights, fleets):
    """Each slot's tokens equal its own stream on an isolated port
    gateway (the budget binds the paged slot, which only changes when
    its requests run, never what they produce)."""
    _, _, cfg, params = weights
    _, treqs, _, _, _ = fleets["torch"]
    for name, (kw, stream) in FLEET_SLOTS.items():
        gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                             device="cpu", **SMALL, **kw)
        reqs = [gw.submit(p, license=t, max_new_tokens=5 - i % 2)
                for i, (t, p) in enumerate(stream())]
        gw.run()
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in treqs[name]], name


# ------------------------------------------------------- engine functions
def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 500, (b, s), dtype=np.int32)


def _jax_stack(tree):
    """The JAX lane-stacked caches (lane, ..., batch 1, ...) as the port's
    one batch cache (..., lane, ...): drop the batch-1 axis and move the
    lane axis to the model's batch position (after the unit axis)."""
    return {k: (_jax_stack(v) if isinstance(v, dict)
                else np.moveaxis(np.asarray(v)[:, :, 0], 0, 1))
            for k, v in tree.items()}


def _port(tree):
    return {k: (_port(v) if isinstance(v, dict) else v.numpy()) for k, v in tree.items()}


def test_right_align_matches_jax():
    prompts = [np.arange(3, dtype=np.int32) + 5, np.arange(6, dtype=np.int32),
               np.asarray([9], np.int32)]
    np.testing.assert_array_equal(engine.right_align(prompts, 6, 4),
                                  jax_engine.right_align(prompts, 6, 4))
    with pytest.raises(ValueError, match="empty prompt at row 1"):
        engine.right_align([prompts[0], np.zeros(0, np.int32)], 6, 2)


def test_stack_lane_caches_matches_jax(weights):
    jcfg, _, cfg, _ = weights
    got = _port(engine.stack_lane_caches(cfg, 3, 16, device="cpu"))
    want = _jax_stack(jax_engine.stack_lane_caches(jcfg, 3, 16))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any() and not w.any()


def test_prefill_suffix_and_serve_steps_match_jax(weights):
    """prefill_step fills fresh lane caches from a right-aligned bucket;
    prefill_suffix_step extends them at per-lane offsets (full logits);
    serve_step decodes one token per lane at per-lane positions.  Each
    step's logits and caches against the JAX functions vmapped over
    lanes, as the JAX gateway runs them."""
    jcfg, jparams, cfg, params = weights
    b, s, cap, w = 3, 8, 24, 4
    toks = _tokens(b, s, 1)
    jlanes = jax_engine.stack_lane_caches(jcfg, b, cap)

    def jprefill(t, c):
        lg, c = jax_engine.prefill_step(jparams, jcfg, t[None], c)
        return lg[0], c

    jl, jc = jax.vmap(jprefill)(jnp.asarray(toks), jlanes)
    tl, tc = engine.prefill_step(params, cfg, torch.from_numpy(toks),
                                 engine.stack_lane_caches(cfg, b, cap, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    for g, want in zip(jax.tree_util.tree_leaves(_port(tc)),
                       jax.tree_util.tree_leaves(_jax_stack(jc))):
        np.testing.assert_allclose(g, want, atol=2e-5, rtol=2e-5)

    # suffix prefill at per-lane offsets into the prefilled caches
    pos = np.asarray([s, s - 2, s - 5], np.int32)
    sub = _tokens(b, w, 2)

    def jsuffix(t, c, p):
        lg, c = jax_engine.prefill_suffix_step(jparams, jcfg, t[None], c, p)
        return lg[0], c

    jl, jc = jax.vmap(jsuffix)(jnp.asarray(sub), jc, jnp.asarray(pos))
    tl, tc = engine.prefill_suffix_step(params, cfg, torch.from_numpy(sub), tc,
                                        torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)

    # one decode step per lane at its own position
    dpos = pos + w
    tok = _tokens(b, 1, 3)

    def jdecode(t, c, p):
        lg, c = jax_engine.serve_step(jparams, jcfg, t[None], c, p)
        return lg[0], c

    jl, jc = jax.vmap(jdecode)(jnp.asarray(tok), jc, jnp.asarray(dpos))
    tl, tc = engine.serve_step(params, cfg, torch.from_numpy(tok), tc, torch.from_numpy(dpos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    for g, want in zip(jax.tree_util.tree_leaves(_port(tc)),
                       jax.tree_util.tree_leaves(_jax_stack(jc))):
        np.testing.assert_allclose(g, want, atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------- squared ReLU
def test_default_gateway_on_squared_relu_matches_jax():
    """The default gateway (chunked prefill, kernel-resident decode, the
    prefix cache) on nemotron-4-15b's smoke variant: the JAX gateway's
    greedy tokens and schedule."""
    jcfg = jax_smoke_variant(jax_get_config("nemotron-4-15b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("nemotron-4-15b"))
    assert cfg.mlp_type == "squared_relu"
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    assert "w_gate" not in params["units"]["b0"]["ffn"]
    stream = _shared_stream()
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     telemetry=False, **SMALL)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          device="cpu", **SMALL)
    jreqs, treqs = _drain(jgw, stream), _drain(tgw, stream)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _observed(tgw) == _observed(jgw)


# ---------------------------------------------------------------- arguments
def test_fallback_argument_checks(weights):
    _, _, cfg, params = weights
    with pytest.raises(ValueError, match="no interpret mode"):
        LicensedGateway(cfg, params, device="cpu", decode_pallas="interpret")
    with pytest.raises(ValueError, match="not in"):
        LicensedGateway(cfg, params, device="cpu", decode_pallas="triton")
    with pytest.raises(ValueError, match="CUDA"):      # as decode_kernels=True
        LicensedGateway(cfg, params, device="cpu", decode_pallas="pallas")
    with pytest.raises(ValueError, match="contradicts"):
        LicensedGateway(cfg, params, device="cpu", decode_pallas="off", decode_kernels=True)
    # kernels asked for on a route that has none
    for kw in (dict(paged=False), dict(kernel_decode=False)):
        with pytest.raises(ValueError, match="kernel-resident decode"):
            LicensedGateway(cfg, params, device="cpu", decode_kernels=True, **kw)
        with pytest.raises(ValueError, match="kernel-resident decode"):
            LicensedGateway(cfg, params, device="cpu", decode_pallas="pallas", **kw)
    with pytest.raises(ValueError, match="requires the paged pool"):
        LicensedGateway(cfg, params, device="cpu", paged=False, chunk_size=4)
    gw = LicensedGateway(cfg, params, device="cpu", paged=False, kernel_decode=True)
    assert not gw.kernel_decode and gw.prefix is None and gw.chunk_size == 0
    assert gw.max_lanes == gw.max_batch and gw.metrics()["decode_path"]["pallas"] == "off"


# ------------------------------------------------------ the recurrent family
# mamba2-130m (no per-token cache leaf: the contiguous pool) and a 5-layer
# recurrentgemma-2b (one (rec, rec, attn) unit and two tail rec blocks;
# the window's ring below the pool's capacity pages, above it is lane
# state), on the routes the JAX slot picks for them by itself
RECURRENT = {"mamba2-130m": None, "recurrentgemma-2b": 5}
# the routes chosen, with kernel_decode=True asked for
RECURRENT_ROUTES = {"mamba2-130m": dict(paged=False, kernel_decode=False, chunk_size=0),
                    "recurrentgemma-2b": dict(paged=True, kernel_decode=False, chunk_size=0)}
VIEWS = {"float": {}, "int8_in_scan": dict(quantized=True),
         "int8_views": dict(quantized=True, materialize_int8_views=True)}


@pytest.fixture(scope="module", params=sorted(RECURRENT))
def recurrent(request):
    name, layers = request.param, RECURRENT[request.param]
    jcfg = jax_smoke_variant(jax_get_config(name))
    cfg = smoke_variant(get_config(name))
    if layers:
        jcfg, cfg = jcfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return name, jcfg, jparams, cfg, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _recurrent_pair(recurrent, **kw):
    name, jcfg, jparams, cfg, params = recurrent
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     telemetry=False, **SMALL, **kw)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          device="cpu", **SMALL, **kw)
    return jgw, tgw


@pytest.mark.parametrize("views", sorted(VIEWS))
def test_recurrent_gateway_matches_jax(recurrent, views):
    """Both tiers' greedy tokens on float views, the in-scan int8 store
    and materialized int8 views, with the JAX gateway's trace, counters
    and metrics sections; ``kernel_decode=True`` asked for and turned
    off on both, no prefix cache, the bucket prefill."""
    jgw, tgw = _recurrent_pair(recurrent, kernel_decode=True, **VIEWS[views])
    stream = _mixed_stream()
    jreqs, treqs = _drain(jgw, stream), _drain(tgw, stream)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _observed(tgw) == _observed(jgw)
    want = RECURRENT_ROUTES[recurrent[0]]
    assert {k: getattr(tgw, k) for k in want} == want == {k: getattr(jgw, k) for k in want}
    assert tgw.prefix is None and jgw.prefix is None and not tgw.decode_kernels
    m = tgw.metrics()
    assert (m["cache_pool"]["paged"], m["decode_path"]["kernel_resident"],
            m["chunked_prefill"]["enabled"]) == (want["paged"], False, False)
    assert tgw.stats["resident_decode_steps"] == 0 and tgw.stats["prefill_chunks"] == 0


def test_recurrent_gateway_argument_checks(recurrent):
    """An explicit chunk size raises as in the JAX slot (the paged
    recurrentgemma: lane state is not a counter; the contiguous mamba2:
    no paged pool); so does asking for the decode kernels."""
    name, jcfg, jparams, cfg, params = recurrent
    match = "reconstructible" if name == "recurrentgemma-2b" else "requires the paged pool"
    for make, tier_cls, p, c, extra in (
            (JaxGateway, JaxLicenseTier, jparams, jcfg, dict(telemetry=False)),
            (LicensedGateway, LicenseTier, params, cfg, dict(device="cpu"))):
        with pytest.raises(ValueError, match=match):
            make(c, p, chunk_size=4, **SMALL_GEOMETRY, **extra)
    with pytest.raises(ValueError, match="kernel-resident decode"):
        LicensedGateway(cfg, params, device="cpu", decode_kernels=True, **SMALL_GEOMETRY)
    gw = LicensedGateway(cfg, params, device="cpu", chunk_size=0, **SMALL_GEOMETRY)
    assert gw.chunk_size == 0


# the pool geometry of SMALL without the lane and block counts
SMALL_GEOMETRY = dict(max_batch=2, max_prompt=12, max_new_cap=8, block_size=4)


def test_recurrent_lane_reuse_starts_from_pristine_state(recurrent):
    """One lane (``max_batch=1``), two requests in a row: the second runs
    on the lane the first left, and must give the tokens it gives on a
    fresh gateway alone (a stale SSM or RG-LRU state would change them),
    and the JAX gateway's."""
    name, jcfg, jparams, cfg, params = recurrent
    geometry = dict(max_batch=1, max_prompt=12, max_new_cap=8, block_size=4)
    prompts = [_prompt(60, 9), _prompt(61, 12)]
    jgw = JaxGateway(jcfg, jparams, telemetry=False, **geometry)
    tgw = LicensedGateway(cfg, params, device="cpu", **geometry)
    out = {}
    for key, gw in (("jax", jgw), ("torch", tgw)):
        reqs = [gw.submit(p, max_new_tokens=6) for p in prompts]
        lanes = []
        while gw.step() is not None:
            lanes += [r.lane for r in reqs if r.lane is not None and r.lane not in lanes]
        assert lanes == [0] and all(r.out_tokens for r in reqs)
        out[key] = [r.out_tokens for r in reqs]
    alone = LicensedGateway(cfg, params, device="cpu", **geometry)
    r = alone.submit(prompts[1], max_new_tokens=6)
    alone.run()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == r.out_tokens

