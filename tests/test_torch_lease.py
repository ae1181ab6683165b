"""The port's license lease against the JAX package's, on the CPU.

The lease cases of ``tests/test_chaos.py`` run through a JAX gateway and
a port gateway booted ``from_server`` from one store file (a
``LicenseServer`` of each package over it), each behind a kill-switch
transport (every wire call times out while ``down``) and on its own
hand-advanced clock, driven in lockstep by the same script.  States,
audit events, ``metrics()["lease"]``, rejection texts, the floor
policy's tokens and ``degraded_seconds_total`` must be identical.  Added
to those cases: a tier refresh deferred by a wire fault (``_tiers_stale``)
re-runs when the lease is restored, and a fleet surfaces the lease and
sync counters of an attached gateway.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import transport as jax_transport
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.protocol import LicenseServer as JaxLicenseServer
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.models import init_params as jax_init_params
from repro.serving import FleetGateway as JaxFleetGateway
from repro.serving import LicensedGateway as JaxGateway

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import transport as torch_transport
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.models.model import params_from_jax
from repro_torch.serving import FleetGateway, LicensedGateway
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_PROMPT = 8
FREE = {"*": ((0.0, 0.004),)}
PRO = {"*": ((0.0, 0.002),)}


def _killable(transport_mod):
    """The package's ``DirectTransport`` with a kill switch: every call
    (``down=True``) or the calls of the named ops (``down={op, ...}``)
    time out."""

    class KillSwitch(transport_mod.DirectTransport):
        def __init__(self, server):
            super().__init__(server)
            self.down = False

        def _call(self, op, thunk):
            if self.down is True or (self.down and op in self.down):
                raise transport_mod.TransportTimeout(f"{op}: server unreachable")
            return super()._call(op, thunk)

    return KillSwitch


PACKAGES = {"jax": dict(transport=jax_transport, fleet=JaxFleetGateway),
            "torch": dict(transport=torch_transport, fleet=FleetGateway)}


class Clock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now


def _noop_sleep(_s):
    pass


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jflat = jax_flatten_params(jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg)))
    return jcfg, smoke_variant(get_config("qwen2.5-3b")), jflat


def _nested(flat):
    out = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


class Side:
    """One package's gateway with its kill-switch transport and clock."""

    def __init__(self, pkg, gw, transport, clock):
        self.pkg, self.gw, self.tr, self.clock = pkg, gw, transport, clock


def _boot(tmp_path, weights, **kw):
    """v1 and the ``free`` (and ``pro``) tiers published once to a store
    file; a JAX and a port gateway booted from it, each through its own
    kill-switch transport on its own clock at 0."""
    jcfg, cfg, jflat = weights
    path = str(tmp_path / "lm.db")
    jserver = JaxLicenseServer(JaxWeightStore(path, row_limit=2048))
    jserver.publish("lm", _nested(jflat), tag="v1")
    jserver.publish_tier("lm", JaxLicenseTier(name="free", masks=FREE))
    jserver.publish_tier("lm", JaxLicenseTier(name="pro", masks=PRO))
    tserver = LicenseServer(WeightStore(path, row_limit=2048))
    zeros = {k: np.zeros_like(v) for k, v in jflat.items()}
    kw = dict(max_batch=2, max_prompt=MAX_PROMPT, max_new_cap=16, **kw)
    sides = []
    for pkg, server in (("jax", jserver), ("torch", tserver)):
        mod = PACKAGES[pkg]["transport"]
        tr = _killable(mod)(server)
        clock = Clock()
        retry = mod.RetryPolicy(max_attempts=2, base_delay_s=0.0, jitter=0.0,
                                sleep=_noop_sleep)
        if pkg == "jax":
            gw = JaxGateway.from_server(jcfg, server, "lm", _nested(zeros), transport=tr,
                                        clock=clock, retry_policy=retry, **kw)
        else:
            gw = LicensedGateway.from_server(cfg, server, "lm",
                                             params_from_jax(zeros, device="cpu"),
                                             transport=tr, clock=clock, retry_policy=retry,
                                             device="cpu", **kw)
        sides.append(Side(pkg, gw, tr, clock))
    return sides, jserver


def _prompt(seed, n=MAX_PROMPT):
    return np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)


class Record:
    """What each side observed, in order, for the cross-package check."""

    def __init__(self, sides):
        self.sides = sides
        self.seen = {s.pkg: [] for s in sides}

    def note(self, label, fn):
        for s in self.sides:
            self.seen[s.pkg].append((label, fn(s)))

    def check(self):
        assert self.seen["torch"] == self.seen["jax"]
        return dict(self.seen["torch"])


def _served(r):
    return (r.state.value, r.license, r.error, list(r.out_tokens))


def _lease(s):
    return s.gw.metrics()["lease"]


# ------------------------------------------------------------------ lease state
def test_lease_state_machine_matches_jax(tmp_path, weights):
    sides, _ = _boot(tmp_path, weights, lease_ttl_s=10.0, lease_grace_s=20.0)
    rec = Record(sides)
    rec.note("boot", _lease)

    def run(s, seed, tier, new):
        r = s.gw.submit(_prompt(seed), license=tier, max_new_tokens=new)
        s.gw.run()
        return _served(r)
    rec.note("warm", lambda s: run(s, 0, "free", 1))
    for s in sides:                       # the server goes dark; past the ttl
        s.tr.down = True
        s.clock.now = 11.0
        s.gw.step()
    rec.note("degraded", _lease)
    rec.note("served while degraded", lambda s: run(s, 1, "free", 2))
    rec.note("new grant refused", lambda s: _served(
        s.gw.submit(_prompt(2), license="pro", max_new_tokens=2)))
    for s in sides:                       # past the grace window
        s.clock.now = 31.5
        s.gw.step()
    rec.note("offline", _lease)
    rec.note("offline reject", lambda s: _served(
        s.gw.submit(_prompt(3), license="free", max_new_tokens=2)))
    for s in sides:                       # the server is back: the probe heals
        s.tr.down = False
        s.clock.now = 33.0
        s.gw.step()
    rec.note("restored", _lease)
    rec.note("served after", lambda s: run(s, 4, "free", 2))
    rec.note("new grant after", lambda s: run(s, 5, "pro", 1))
    rec.note("audit", lambda s: s.gw.audit_events())
    rec.note("prometheus", lambda s: s.gw.render_prometheus())
    rec.note("trace", lambda s: s.gw.chrome_trace())
    seen = rec.check()

    assert seen["boot"]["state"] == "healthy" and seen["warm"][0] == "done"
    assert seen["degraded"]["state"] == "degraded"
    assert seen["served while degraded"][0] == "done"
    state, _, error, _ = seen["new grant refused"]
    assert state == "rejected" and "refusing new tier grant" in error
    assert seen["offline"]["state"] == "offline"
    assert "lease offline" in seen["offline reject"][2]
    assert seen["restored"]["state"] == "healthy"
    # degraded span 11.0 -> 33.0 on the hand clock
    assert seen["restored"]["degraded_seconds_total"] == pytest.approx(22.0)
    assert seen["served after"][0] == seen["new grant after"][0] == "done"
    events = [e["event"] for e in seen["audit"] if e["event"].startswith("lease")]
    assert events == ["lease_degraded", "lease_offline", "lease_restored"]
    assert 'serving_license_lease_state{model="lm"} 0' in seen["prometheus"]
    assert 'serving_degraded_seconds_total{model="lm"} 22.0' in seen["prometheus"]


def test_offline_floor_policy_matches_jax(tmp_path, weights):
    sides, _ = _boot(tmp_path, weights, lease_ttl_s=1.0, lease_grace_s=1.0,
                     lease_policy="floor", lease_floor_tier="free")
    rec = Record(sides)

    def run(s, tier):
        r = s.gw.submit(_prompt(1), license=tier, max_new_tokens=4)
        state_at_submit = r.state.value
        s.gw.run()
        return (state_at_submit,) + _served(r)
    rec.note("reference", lambda s: run(s, "free"))
    for s in sides:
        s.tr.down = True
        s.clock.now = 5.0
        s.gw.step()
    rec.note("offline", _lease)
    rec.note("floored", lambda s: run(s, "full"))
    rec.note("floor instants", lambda s: [e for e in s.gw.tracer.events
                                          if e[3] == "lease_floor"])
    seen = rec.check()
    assert seen["offline"]["state"] == "offline" and seen["offline"]["policy"] == "floor"
    at_submit, state, license, _, tokens = seen["floored"]
    assert at_submit != "rejected" and state == "done" and license == "free"
    assert tokens == seen["reference"][4]        # really served under the floor
    assert len(seen["floor instants"]) == 1


def test_unknown_lease_policy_rejected_alike(weights):
    jcfg, cfg, jflat = weights
    errors = []
    for make in (lambda: JaxGateway(jcfg, _nested(jflat), lease_policy="lax"),
                 lambda: LicensedGateway(cfg, params_from_jax(jflat, device="cpu"),
                                         device="cpu", lease_policy="lax")):
        with pytest.raises(ValueError) as e:
            make()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "lease_policy='lax'" in errors[1]


def test_deferred_tier_refresh_reruns_on_restore(tmp_path, weights):
    """A tier refresh that meets a wire fault defers (the current tiers
    keep serving, ``_tiers_stale`` set); the next lease restore re-runs
    it, and the redefinition published meanwhile lands."""
    sides, jserver = _boot(tmp_path, weights, lease_ttl_s=10.0, lease_grace_s=20.0)
    rec = Record(sides)

    def run(s, seed):
        r = s.gw.submit(_prompt(seed), license="free", max_new_tokens=2)
        s.gw.run()
        return _served(r)
    rec.note("learn free", lambda s: run(s, 0))
    # the operator tightens "free" on the server (the same version)
    jserver.publish_tier("lm", JaxLicenseTier(name="free", masks=PRO))

    def refresh_under_fault(s):
        s.tr.down = {"tier"}
        got = s.gw.begin_sync()          # current: a tier-only refresh
        return (got, s.gw._tiers_stale, s.gw.tiers["free"].masks, s.gw.stats["sync_retries"],
                s.gw.stats["sync_timeouts"])
    rec.note("deferred", refresh_under_fault)
    rec.note("still serving", lambda s: run(s, 1))
    for s in sides:
        s.tr.down = True
        s.clock.now = 11.0
        s.gw.step()
    rec.note("degraded", lambda s: (_lease(s)["state"], s.gw._tiers_stale))
    for s in sides:
        s.tr.down = False
        s.clock.now = 12.0
        s.gw.step()
    rec.note("restored", lambda s: (_lease(s)["state"], s.gw._tiers_stale,
                                    s.gw.tiers["free"].masks))
    rec.note("served after", lambda s: run(s, 2))
    rec.note("audit", lambda s: s.gw.audit_events())
    seen = rec.check()

    got, stale, masks, retries, timeouts = seen["deferred"]
    assert got is False and stale is True and retries == timeouts == 1
    assert masks == {k: tuple(v) for k, v in FREE.items()}
    assert seen["still serving"][0] == "done"
    assert seen["degraded"] == ("degraded", True)
    state, stale, masks = seen["restored"]
    assert state == "healthy" and stale is False
    assert masks == {k: tuple(v) for k, v in PRO.items()}
    assert seen["served after"][0] == "done"
    assert [e["event"] for e in seen["audit"]
            if e["event"] in ("sync_retry", "lease_restored", "tier_redefine")] == \
        ["sync_retry", "lease_restored", "tier_redefine"]


def test_fleet_surfaces_lease_and_sync_counters(tmp_path, weights):
    sides, _ = _boot(tmp_path, weights)
    rec = Record(sides)

    def attached(s):
        fleet = PACKAGES[s.pkg]["fleet"]()
        fleet.attach(s.gw)
        m = fleet.metrics()["models"]["lm"]
        return (m["lease"], m["sync_retries"], m["sync_quarantines"],
                fleet.render_prometheus())
    rec.note("fleet", attached)
    lease, retries, quarantines, page = rec.check()["fleet"]
    assert lease["state"] == "healthy" and lease["server_attached"] is True
    assert (lease["ttl_s"], lease["grace_s"], lease["policy"]) == (60.0, 300.0, "reject")
    assert retries == quarantines == 0
    for series in ("serving_license_lease_state", "serving_sync_retries_total",
                   "serving_degraded_seconds_total"):
        assert series in page
