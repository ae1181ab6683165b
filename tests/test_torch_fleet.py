"""The port's fleet (``FleetGateway``, ``TenantRegistry``, the global
cache budget) against the JAX package's, on the CPU.

Two smoke-size qwen2.5-3b slots on weights from the JAX ``init_params``
(carried across with ``params_from_jax``): ``float`` (seed 0, float
views) and ``int8`` (seed 1, ``quantized=True``: the int8 store
dequantized inside every step).  Every case of ``tests/test_fleet.py``
runs through both packages' fleets on hand-advanced clocks moved by the
same fixed steps, and must give identical tokens per request, identical
model-tagged actions in the same order, identical tenant stats,
``metrics()`` (the port's one extra key, ``decode_path.kernels``, aside),
audit events, Prometheus page and Chrome trace.  The port's fleet must
also equal isolated port gateways fed each slot's stream, and the
``TenantRegistry`` unit cases run through both registries with identical
results.  A heterogeneous fleet (a qwen2.5-3b slot beside a
deepseek-v2-lite-16b slot, MLA's compressed cache a third of a qwen
block's bytes) under one byte budget must give the JAX fleet's tokens,
per-slot ``block_bytes`` and cross-slot evictions.  The JAX fleet
test's trio (qwen2.5-3b, mamba2-130m on the contiguous pool,
recurrentgemma-2b with its lane state) must give the JAX fleet's tokens
and actions.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import FleetGateway as JaxFleetGateway
from repro.serving import TenantRegistry as JaxTenantRegistry
from repro.serving import telemetry as jax_telemetry

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models.model import params_from_jax
from repro_torch.serving import (FleetGateway, LicensedGateway, RequestState,
                                 TenantRegistry, validate_fleet_metrics)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREE = {"*": ((0.0, 0.01),)}
# small pool, prompts off block multiples (block_size 4): preemption and
# prefix reuse happen inside each slot
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)
SLOTS = {"float": (0, {}), "int8": (1, dict(quantized=True))}
# the port's one metrics() key outside the JAX schema
PORT_EXTRA = ("decode_path.kernels",)
SUBMIT_DT, STEP_DT = 0.25, 0.5


class Clock:
    """Hand-advanced clock: reads ``now`` and never moves on its own."""

    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    out = {}
    for name, (seed, _) in SLOTS.items():
        jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
        out[name] = (jparams, params_from_jax(jax_flatten_params(jparams), device="cpu"))
    return jcfg, cfg, out


PACKAGES = {
    "jax": dict(fleet=JaxFleetGateway, registry=JaxTenantRegistry, tier=JaxLicenseTier,
                slot_kw={}),
    "torch": dict(fleet=FleetGateway, registry=TenantRegistry, tier=LicenseTier,
                  slot_kw=dict(device="cpu")),
}


def _fleet(pkg, weights, clock, *, slots=("float", "int8"), tenants=None,
           budget=None, **slot_kw):
    """One package's fleet on ``clock`` with the named slots."""
    jcfg, cfg, params = weights
    p = PACKAGES[pkg]
    fleet = p["fleet"](clock=clock, tenants=p["registry"](clock=clock),
                       cache_budget_bytes=budget)
    for name, kw in (tenants or {}).items():     # into the fleet's audit
        fleet.tenants.register(name, **kw)
    geometry = {**GEOMETRY, **slot_kw}
    for name in slots:
        _, mode = SLOTS[name]
        fleet.add_model(name, jcfg if pkg == "jax" else cfg,
                        params[name][0 if pkg == "jax" else 1],
                        tiers={"free": p["tier"](name="free", masks=FREE)},
                        **mode, **geometry, **p["slot_kw"])
    return fleet


def _prompt(i, n):
    return np.random.default_rng(100 + i).integers(0, 500, n, dtype=np.int32)


def _steps(fleet, clock, budget=None):
    """Step to the drain, a fixed clock step apart; the model-tagged
    actions, and (with ``budget``) the bytes in use after every step."""
    acts, used = [], []
    for _ in range(500):
        act = fleet.step()
        clock.now += STEP_DT
        used.append(fleet.used_cache_bytes())
        if budget is not None:
            assert used[-1] <= budget, "global cache budget exceeded"
        if act is None:
            return acts, used
        acts.append((act.model, act.kind, act.tier, act.version, len(act.requests)))
    raise AssertionError("fleet did not drain")


# (model, tier, prompt length, max_new_tokens, tenant)
JOBS = [("float", "full", 7, 6, "acme"), ("int8", "free", 5, 7, "acme"),
        ("float", "free", 11, 8, None), ("int8", "full", 9, 6, "beta"),
        ("float", "full", 3, 7, "beta"), ("int8", "free", 10, 8, None),
        ("float", "free", 6, 5, "acme"), ("int8", "full", 12, 4, "acme"),
        # a prompt over max_prompt: bounced by the gateway after the
        # quota charge, which the fleet refunds
        ("float", "full", 13, 4, "acme")]
TENANTS = {"acme": dict(entitlements=("*:*",), rate=2.0, burst=8.0),
           "beta": dict(entitlements=("float:*", "int8:full"), max_concurrent=2)}


def _serve(pkg, weights):
    clock = Clock()
    fleet = _fleet(pkg, weights, clock, tenants=TENANTS)
    reqs = []
    for i, (model, tier, n, new, tenant) in enumerate(JOBS):
        reqs.append(fleet.submit(model, _prompt(i, n), license=tier,
                                 max_new_tokens=new, tenant=tenant))
        clock.now += SUBMIT_DT
    acts, _ = _steps(fleet, clock)
    return fleet, reqs, acts


@pytest.fixture(scope="module")
def served(weights):
    return {pkg: _serve(pkg, weights) for pkg in PACKAGES}


def test_tokens_and_actions_identical(served):
    (jf, jreqs, jacts), (tf, treqs, tacts) = served["jax"], served["torch"]
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [(r.state.value, r.error, r.license, r.model) for r in treqs] == \
        [(r.state.value, r.error, r.license, r.model) for r in jreqs]
    assert tacts == jacts
    assert {a[0] for a in tacts} == {"float", "int8"}
    assert len({a[0] for a in tacts[:2]}) == 2       # round-robin, not drain-one
    assert [r.state for r in treqs[:-1]] == [RequestState.DONE] * (len(JOBS) - 1)
    assert treqs[-1].state == RequestState.REJECTED and "prompt length" in treqs[-1].error
    assert sum(g.stats["preempted"] for g in tf.gateways.values()) > 0
    for name, gw in tf.gateways.items():
        assert list(gw.trace) == list(jf.gateways[name].trace)
        assert gw.pool.allocator.num_held == jf.gateways[name].pool.allocator.num_held


def test_tenant_stats_identical(served):
    jf, tf = served["jax"][0], served["torch"][0]
    stats = tf.tenants.stats()
    assert stats == jf.tenants.stats()
    assert stats["acme"]["inflight"] == stats["beta"]["inflight"] == 0
    # the over-long prompt's charge was refunded
    assert (stats["acme"]["submitted"], stats["acme"]["admitted"],
            stats["acme"]["completed"]) == (5, 4, 4)


def test_metrics_identical(served):
    jf, tf = served["jax"][0], served["torch"][0]
    jm, tm = jf.metrics(), tf.metrics()
    validate_fleet_metrics(tm, extra=PORT_EXTRA)
    jax_telemetry.validate_fleet_metrics(jm)
    with pytest.raises(AssertionError, match="decode_path.kernels"):
        validate_fleet_metrics(tm)
    assert tm["fleet"] == jm["fleet"] and tm["tenants"] == jm["tenants"]
    assert set(tm["models"]) == set(jm["models"]) == {"float", "int8"}
    for name, m in tm["models"].items():
        want = jm["models"][name]
        assert m["decode_path"] == {**want["decode_path"], "kernels": False}
        assert {k: v for k, v in m.items() if k != "decode_path"} == \
            {k: v for k, v in want.items() if k != "decode_path"}, name
    assert tm["fleet"]["completed"] == len(JOBS) - 1 and tm["fleet"]["steps"] > 0


def test_audit_prometheus_and_trace_identical(served):
    jf, tf = served["jax"][0], served["torch"][0]
    assert tf.audit_events() == jf.audit_events()
    events = {e["event"] for e in tf.audit_events()}
    assert {"tenant_register", "tier_grant", "view_materialize"} <= events
    page = tf.render_prometheus()
    assert page == jf.render_prometheus()
    for series in ("fleet_cache_used_bytes", "tenant_inflight", "tenant_completed_total",
                   "serving_license_lease_state", "serving_degraded_seconds_total"):
        assert series in page, series
    assert tf.chrome_trace() == jf.chrome_trace()


def test_fleet_equals_isolated_port_gateways(weights, served):
    """The fleet only interleaves slots: each slot's tokens equal an
    isolated port gateway fed the same stream on the same schedule."""
    _, cfg, params = weights
    _, treqs, _ = served["torch"]
    for name, (_, mode) in SLOTS.items():
        clock = Clock()
        gw = LicensedGateway(cfg, params[name][1], model=name, clock=clock, device="cpu",
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             **mode, **GEOMETRY)
        mine = [(i, j) for i, j in enumerate(JOBS) if j[0] == name]
        reqs = [gw.submit(_prompt(i, n), license=tier, max_new_tokens=new, tenant=tenant)
                for i, (_, tier, n, new, tenant) in mine]
        gw.run()
        assert [r.out_tokens for r in reqs] == [treqs[i].out_tokens for i, _ in mine]


# ---------------------------------------------------------- global budget
def _contention(pkg, weights):
    """Tenants t1, t2 contend for model "float" and t3 uses "int8" under
    a budget of one live request per slot (a capacity of 12 tokens: 3
    blocks, all of which each request fills)."""
    clock = Clock()
    tenants = {"t1": dict(entitlements=("float:*",)), "t2": dict(entitlements=("float:*",)),
               "t3": dict(entitlements=("int8:*",))}
    geometry = dict(max_batch=1, prefix_cache=False, max_prompt=8, max_new_cap=4)
    probe = _fleet(pkg, weights, clock, slots=("float",), **geometry)
    budget = 6 * probe.gateways["float"].pool.block_bytes
    fleet = _fleet(pkg, weights, clock, tenants=tenants, budget=budget, **geometry)
    reqs = [fleet.submit(m, _prompt(i, 8), tenant=t, license="full", max_new_tokens=4)
            for i, (m, t) in enumerate((("float", "t1"), ("float", "t2"), ("int8", "t3")))]
    assert all(r.state.value != "rejected" for r in reqs)
    gw = fleet.gateways["float"]
    saw = False
    for _ in range(500):
        act = fleet.step()
        clock.now += STEP_DT
        used = fleet.used_cache_bytes()
        assert used <= budget, "global cache budget exceeded"
        saw |= used == budget and len(gw.scheduler.waiting) == 1
        if act is None:
            break
    return fleet, reqs, saw


def test_budget_contention_spares_the_other_model(weights):
    got = {pkg: _contention(pkg, weights) for pkg in PACKAGES}
    (jf, jreqs, jsaw), (tf, treqs, tsaw) = got["jax"], got["torch"]
    assert tsaw and jsaw                    # t2 gated while the budget was full
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    stats = tf.tenants.stats()
    assert stats == jf.tenants.stats()
    assert all(stats[t]["completed"] == 1 and stats[t]["inflight"] == 0
               for t in ("t1", "t2", "t3"))


def _pressure(pkg, weights):
    """Prefix chains retained by a first wave on both slots, then a
    second wave of new prompts under a budget below both waves' need:
    allocation evicts chains across slots, never past the budget."""
    clock = Clock()
    fleet = _fleet(pkg, weights, clock, budget=None)
    bb = fleet.gateways["float"].pool.block_bytes
    fleet = _fleet(pkg, weights, clock, budget=10 * bb)
    # (slot asking for room, slot whose chains were evicted, blocks freed)
    evicted, asking = [], []
    ensure = fleet._ensure_headroom

    def ensure_headroom(gw, n):
        asking.append(gw.model)
        try:
            return ensure(gw, n)
        finally:
            asking.pop()
    fleet._ensure_headroom = ensure_headroom
    for name, gw in fleet.gateways.items():
        evict = gw.prefix.evict

        def counted(n, evict=evict, name=name):
            got = evict(n)
            evicted.append((asking[-1] if asking else name, name, got))
            return got
        gw.prefix.evict = counted
    reqs = []
    for wave in range(2):
        for i in range(6):
            name = ("float", "int8")[i % 2]
            reqs.append(fleet.submit(name, _prompt(10 * wave + i, 5 + i), max_new_tokens=4,
                                     license=("full", "free")[i // 2 % 2]))
            clock.now += SUBMIT_DT
        _, used = _steps(fleet, clock, budget=10 * bb)
    return fleet, reqs, evicted


def test_budget_pressure_evicts_across_slots(weights):
    got = {pkg: _pressure(pkg, weights) for pkg in PACKAGES}
    (jf, jreqs, jev), (tf, treqs, tev) = got["jax"], got["torch"]
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert tev == jev
    assert sum(got for asker, owner, got in tev if asker != owner) > 0
    for name, gw in tf.gateways.items():
        assert gw.metrics()["prefix_cache"] == jf.gateways[name].metrics()["prefix_cache"]


def test_budget_must_hold_one_request_per_slot(weights):
    errors = {}
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="cannot hold") as e:
            _fleet(pkg, weights, Clock(), slots=("float",), budget=1)
        errors[pkg] = str(e.value)
    assert errors["torch"] == errors["jax"]


# ------------------------------------------------------ heterogeneous fleet
MIXED = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def mixed_weights(weights):
    """The qwen2.5-3b "float" slot's weights and a deepseek-v2-lite-16b
    smoke model (MLA's compressed cache, MoE) from seed 1, in both
    packages."""
    jcfg, cfg, params = weights
    jmla = jax_smoke_variant(jax_get_config(MIXED))
    jparams = jax_init_params(jax.random.PRNGKey(1), jmla)
    return {"qwen": (jcfg, cfg, *params["float"]),
            "mla": (jmla, smoke_variant(get_config(MIXED)), jparams,
                    params_from_jax(jax_flatten_params(jparams), device="cpu"))}


def _mixed(pkg, mixed_weights):
    """Both slots under one global budget of 4 qwen blocks and 12 MLA
    blocks (a qwen block is 8,192 bytes, an MLA block 2,560): two waves
    of new prompts, each slot asking for room the other one's retained
    chains hold.  Returns the fleet, the requests and the evictions as
    (slot asking, slot evicted, blocks)."""
    clock = Clock()
    p = PACKAGES[pkg]

    def build(budget):
        fleet = p["fleet"](clock=clock, tenants=p["registry"](clock=clock),
                           cache_budget_bytes=budget)
        for name, (jcfg, cfg, jparams, params) in mixed_weights.items():
            fleet.add_model(name, jcfg if pkg == "jax" else cfg,
                            jparams if pkg == "jax" else params,
                            tiers={"free": p["tier"](name="free", masks=FREE)},
                            **GEOMETRY, **p["slot_kw"])
        return fleet

    probe = build(None).gateways
    budget = 4 * probe["qwen"].pool.block_bytes + 12 * probe["mla"].pool.block_bytes
    fleet = build(budget)
    evicted, asking = [], []
    ensure = fleet._ensure_headroom

    def ensure_headroom(gw, n):
        asking.append(gw.model)
        try:
            return ensure(gw, n)
        finally:
            asking.pop()
    fleet._ensure_headroom = ensure_headroom
    for name, gw in fleet.gateways.items():
        evict = gw.prefix.evict

        def counted(n, evict=evict, name=name):
            got = evict(n)
            evicted.append((asking[-1] if asking else name, name, got))
            return got
        gw.prefix.evict = counted
    reqs = []
    for wave in range(2):
        for i in range(6):
            reqs.append(fleet.submit(("qwen", "mla")[i % 2], _prompt(10 * wave + i, 5 + i),
                                     max_new_tokens=4, license=("full", "free")[i // 2 % 2]))
            clock.now += SUBMIT_DT
        _steps(fleet, clock, budget=budget)
    return fleet, reqs, evicted


def test_heterogeneous_fleet_matches_jax(mixed_weights):
    """A qwen2.5-3b slot and a deepseek-v2-lite-16b slot under one budget:
    each slot's ``block_bytes`` (the budget's exchange rate: K and V of 2
    units against MLA's latent and rotary key) equals the JAX pool's, and
    the tokens, the cross-slot evictions (both ways) and the prefix
    counters equal the JAX fleet's."""
    got = {pkg: _mixed(pkg, mixed_weights) for pkg in PACKAGES}
    (jf, jreqs, jev), (tf, treqs, tev) = got["jax"], got["torch"]
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    for name, gw in tf.gateways.items():
        assert gw.pool.block_bytes == jf.gateways[name].pool.block_bytes
        assert gw.metrics()["prefix_cache"] == jf.gateways[name].metrics()["prefix_cache"]
    assert tf.gateways["qwen"].pool.block_bytes != tf.gateways["mla"].pool.block_bytes
    assert tev == jev
    assert {(a, o) for a, o, n in tev if a != o and n} == {("qwen", "mla"), ("mla", "qwen")}


# ------------------------------------------------------------ the JAX trio
# the JAX fleet test's trio: a GQA transformer (paged, chunked prefill),
# a pure SSM (the contiguous pool) and a window / RG-LRU hybrid (paged,
# bucket prefill, gather/scatter decode; 5 layers, so two tail blocks)
TRIO = {"qwen2.5-3b": None, "mamba2-130m": None, "recurrentgemma-2b": 5}


@pytest.fixture(scope="module")
def trio():
    out = {}
    for i, (name, layers) in enumerate(TRIO.items()):
        jcfg, cfg = jax_smoke_variant(jax_get_config(name)), smoke_variant(get_config(name))
        if layers:
            jcfg, cfg = jcfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
        jparams = jax_init_params(jax.random.PRNGKey(i), jcfg)
        out[name] = (jcfg, cfg, jparams, params_from_jax(jax_flatten_params(jparams),
                                                         device="cpu"))
    return out


def _trio_run(pkg, trio):
    """Three jobs a model, tiers alternating, submitted a fixed clock
    step apart and stepped to the drain.  Returns the fleet, the
    requests and the model-tagged actions."""
    clock = Clock()
    p = PACKAGES[pkg]
    fleet = p["fleet"](clock=clock, tenants=p["registry"](clock=clock))
    for name, (jcfg, cfg, jparams, params) in trio.items():
        fleet.add_model(name, jcfg if pkg == "jax" else cfg,
                        jparams if pkg == "jax" else params,
                        tiers={"free": p["tier"](name="free", masks=FREE)},
                        **dict(GEOMETRY, num_blocks=12), **p["slot_kw"])
    reqs = []
    for i, name in enumerate(trio):
        for j in range(3):
            reqs.append(fleet.submit(name, _prompt(10 * i + j, 5 + 3 * j),
                                     license="free" if (i + j) % 2 else "full",
                                     max_new_tokens=3 + j))
            clock.now += SUBMIT_DT
    acts, _ = _steps(fleet, clock)
    return fleet, reqs, acts


def test_trio_fleet_matches_jax(trio):
    """qwen2.5-3b, mamba2-130m and recurrentgemma-2b behind one fleet:
    the JAX fleet's tokens, model-tagged actions and each slot's routes
    and metrics sections; every slot's tokens equal an isolated port
    gateway's."""
    (jf, jreqs, jacts), (tf, treqs, tacts) = (_trio_run(pkg, trio) for pkg in PACKAGES)
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert tacts == jacts and {a[0] for a in tacts} == set(TRIO)
    routes = {name: (gw.paged, gw.kernel_decode, gw.chunk_size, gw.prefix is not None)
              for name, gw in tf.gateways.items()}
    assert routes == {name: (gw.paged, gw.kernel_decode, gw.chunk_size, gw.prefix is not None)
                      for name, gw in jf.gateways.items()}
    assert routes["mamba2-130m"] == (False, False, 0, False)
    assert routes["recurrentgemma-2b"] == (True, False, 0, False)
    m, jm = tf.metrics(), jf.metrics()
    validate_fleet_metrics(m, extra=PORT_EXTRA)
    for name in TRIO:
        for key in ("cache_pool", "chunked_prefill", "prefix_cache"):
            assert m["models"][name][key] == jm["models"][name][key], (name, key)
    for name, (_, cfg, _, params) in trio.items():
        gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                             device="cpu", **dict(GEOMETRY, num_blocks=12))
        mine = [r for r in treqs if r.model == name]
        alone = [gw.submit(r.prompt, license=r.license, max_new_tokens=r.max_new_tokens)
                 for r in mine]
        gw.run()
        assert [r.out_tokens for r in alone] == [r.out_tokens for r in mine], name


# ------------------------------------------------------- tenant enforcement
def _both(fn, weights):
    return {pkg: fn(pkg, weights) for pkg in PACKAGES}


def test_unknown_model_and_unknown_tenant_rejected(weights):
    def run(pkg, weights):
        fleet = _fleet(pkg, weights, Clock(), slots=("float",))
        a = fleet.submit("no-such-model", _prompt(0, 4))
        b = fleet.submit("float", _prompt(0, 4), tenant="ghost")
        return [(r.state.value, r.error, r.model, r.tenant) for r in (a, b)], \
            fleet.metrics()["fleet"]
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    (a, b), _ = got["torch"]
    assert "unknown model" in a[1] and "unknown tenant" in b[1]


def test_zero_quota_tenant_never_admitted(weights):
    def run(pkg, weights):
        fleet = _fleet(pkg, weights, Clock(), slots=("float",),
                       tenants={"broke": dict(max_concurrent=0)})
        r = fleet.submit("float", _prompt(0, 4), tenant="broke", license="free")
        m = fleet.metrics()
        return r.error, fleet.tenants.stats(), m["fleet"], m["models"]["float"]["quota_rejections"]
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    error, stats, fleet, rejections = got["torch"]
    assert "quota" in error and rejections == fleet["quota_rejections"] == 1
    s = stats["broke"]
    assert (s["submitted"], s["admitted"], s["quota_rejections"]) == (1, 0, 1)


def test_entitlement_checked_at_submit(weights):
    def run(pkg, weights):
        clock = Clock()
        fleet = _fleet(pkg, weights, clock, tenants={"narrow": dict(entitlements=("int8:free",))})
        ok = fleet.submit("int8", _prompt(0, 6), tenant="narrow", license="free",
                          max_new_tokens=3)
        bad = [fleet.submit(m, _prompt(1, 6), tenant="narrow", license=t, max_new_tokens=3)
               for m, t in (("int8", "full"), ("float", "free"))]
        _steps(fleet, clock)
        return ok.state.value, ok.out_tokens, [r.error for r in bad], fleet.tenants.stats()
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    state, _, errors, _ = got["torch"]
    assert state == "done" and all("not entitled" in e for e in errors)


def test_revocation_while_queued_drains_inflight(weights):
    """The decoding request completes; the queued one is rejected at the
    next batch formation; nothing is left to submit under."""
    def run(pkg, weights):
        clock = Clock()
        fleet = _fleet(pkg, weights, clock, slots=("int8",), max_batch=1,
                       tenants={"acme": dict(entitlements=("int8:free",))})
        r1, r2 = (fleet.submit("int8", _prompt(i, 6), tenant="acme", license="free",
                               max_new_tokens=4) for i in range(2))
        while r1.state.value != "running":          # either package's enum
            fleet.step()
            clock.now += STEP_DT
        assert r2.state.value == "queued"
        fleet.tenants.revoke("acme", "int8", "free")
        _steps(fleet, clock)
        r3 = fleet.submit("int8", _prompt(2, 6), tenant="acme", license="free")
        return ([(r.state.value, r.error, r.out_tokens) for r in (r1, r2, r3)],
                fleet.tenants.stats(), fleet.audit_events(),
                fleet.metrics()["models"]["int8"]["rejected"])
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    (r1, r2, r3), stats, audit, rejected = got["torch"]
    assert r1[0] == "done" and len(r1[2]) == 4
    assert r2[0] == "rejected" and "revoked while queued" in r2[1]
    assert r3[0] == "rejected" and rejected == 2
    s = stats["acme"]
    assert (s["completed"], s["quota_rejections"], s["inflight"]) == (1, 2, 0)
    assert [e["event"] for e in audit if e["event"].startswith(("tenant", "quota"))] == \
        ["tenant_register", "tenant_reject", "quota_reject"]


def test_rate_limit_enforced_at_submit(weights):
    def run(pkg, weights):
        clock = Clock()
        fleet = _fleet(pkg, weights, clock, slots=("float",),
                       tenants={"slow": dict(rate=0.5, burst=1.0)})
        a = fleet.submit("float", _prompt(0, 4), tenant="slow", license="free",
                         max_new_tokens=2)
        b = fleet.submit("float", _prompt(1, 4), tenant="slow", license="free",
                         max_new_tokens=2)
        clock.now += 2.0                                 # one token back
        c = fleet.submit("float", _prompt(2, 4), tenant="slow", license="free",
                         max_new_tokens=2)
        _steps(fleet, clock)
        return [(r.state.value, r.error, r.out_tokens) for r in (a, b, c)], \
            fleet.tenants.stats()
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    (a, b, c), _ = got["torch"]
    assert a[0] == c[0] == "done" and b[0] == "rejected" and "rate-limited" in b[1]


def test_queue_waits_are_per_slot(weights):
    def run(pkg, weights):
        clock = Clock()
        fleet = _fleet(pkg, weights, clock)
        fleet.submit("float", _prompt(0, 4), license="free", max_new_tokens=2)
        clock.now += 0.02
        m = fleet.metrics()
        _steps(fleet, clock)
        return {n: (mm["oldest_wait_s"], mm["queue_wait_by_tier"])
                for n, mm in m["models"].items()}, m["fleet"]["oldest_wait_s"]
    got = _both(run, weights)
    assert got["torch"] == got["jax"]
    waits, oldest = got["torch"]
    assert waits["float"][0] == pytest.approx(0.02) and "free" in waits["float"][1]
    assert waits["int8"] == (0.0, {}) and oldest == waits["float"][0]


class _FakeStager:
    """Stand-in with the two members the fleet loop touches (``active``,
    ``step``), counting the bounded steps it was given."""

    def __init__(self, n):
        self.left = n

    @property
    def active(self):
        return self.left > 0

    def step(self):
        assert self.left > 0
        self.left -= 1
        return "stage"


def test_at_most_one_stager_step_per_fleet_iteration(weights):
    fleet = _fleet("torch", weights, Clock())
    fakes = [_FakeStager(3), _FakeStager(3)]
    for gw, fake in zip(fleet.gateways.values(), fakes):
        gw._stager = fake
    for i in range(6):
        fleet.step()
        assert sum(3 - f.left for f in fakes) == i + 1, "two stagers stepped at once"
    assert not any(g.sync_active for g in fleet.gateways.values())
    assert fleet.run() == []


def test_attach_wires_a_standalone_gateway(weights):
    """``attach`` adopts a gateway with its own registry and refuses a
    second fleet or a duplicate name."""
    _, cfg, params = weights
    gw = LicensedGateway(cfg, params["float"][1], model="solo", device="cpu", **GEOMETRY)
    fleet = FleetGateway()
    fleet.attach(gw)
    assert gw.slot.fleet is fleet and gw.scheduler.global_budget is not None
    assert 'serving_queue_depth{model="solo"}' in fleet.render_prometheus()
    with pytest.raises(ValueError, match="already registered"):
        fleet.attach(gw)
    with pytest.raises(ValueError, match="already belongs to a fleet"):
        FleetGateway().attach(gw)
    r = fleet.submit("solo", _prompt(0, 5), max_new_tokens=3)
    fleet.run()
    assert r.state is RequestState.DONE and r.model == "solo"


# ------------------------------------------------------------ TenantRegistry
def _registry_trace(Registry):
    """Drive one registry through every method on a hand clock; the
    results, rejection texts, exceptions and stats at each point."""
    now = {"t": 0.0}
    reg = Registry(clock=lambda: now["t"])
    out = []

    def note(x):
        out.append(x)
    reg.register("u", rate=1.0, burst=2.0)
    for _ in range(3):
        note(reg.acquire("u", "m", "full"))          # burst, burst, denied
    now["t"] += 1.0                                  # refills one token
    note(reg.acquire("u", "m", "full"))
    note(reg.acquire("u", "m", "full"))
    now["t"] += 30.0                                 # caps at burst
    for _ in range(3):
        note(reg.acquire("u", "m", "full"))
    reg.cancel("u")                                  # refund: token back
    note(reg.acquire("u", "m", "full"))
    reg.drop_queued("u")
    reg.finish("u", 7)
    reg.finish("ghost", 3)                           # deleted mid-flight
    note(reg.stats())
    reg.register("v", entitlements=[("a", "free"), "b:", ":x"], max_concurrent=1)
    note((reg.entitled("v", "a", "free"), reg.entitled("v", "a", "full"),
          reg.entitled("v", "b", "full"), reg.entitled("v", "c", "x"),
          reg.entitled("ghost", "a", "free"), reg.known("v"), reg.known("ghost")))
    note(reg.acquire("v", "a", "free"))
    note(reg.acquire("v", "a", "free"))              # concurrency quota
    note(reg.acquire("v", "a", "full"))              # not entitled
    note(reg.acquire("nobody", "a", "free"))
    reg.grant("v", "c", "full")
    reg.revoke("v", "b", "anything")                 # the b:* wildcard goes
    reg.revoke("v", "*", "x")
    note(reg.stats()["v"])
    reg.register("v", entitlements=("*:*",))         # redefinition keeps usage
    note(reg.stats()["v"])
    try:
        reg.register("w", rate=1.0, burst=0.5)
    except ValueError as e:
        note(str(e))
    return out


def test_registry_matches_jax():
    got = _registry_trace(TenantRegistry)
    assert got == _registry_trace(JaxTenantRegistry)
    assert got[2] is not None and "rate-limited" in got[2]
    assert got[0] is None and got[3] is None
    assert "burst=0.5 < 1" in got[-1]


def test_registry_audit_matches_jax():
    """A fleet wires its audit log into the registry: definitions and
    grants land there (revocations do not, as in the JAX package)."""
    logs = {}
    for pkg, p in PACKAGES.items():
        fleet = p["fleet"](clock=Clock())
        fleet.tenants.register("a", entitlements=("m:free",), max_concurrent=2, rate=3.0)
        fleet.tenants.grant("a", "m", "full")
        fleet.tenants.revoke("a", "m", "free")
        logs[pkg] = fleet.audit_events()
    assert logs["torch"] == logs["jax"]
    assert [e["event"] for e in logs["torch"]] == ["tenant_register", "entitlement_grant"]
