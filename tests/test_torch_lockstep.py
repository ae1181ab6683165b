"""The port's lockstep race checker and its staged sync under it, on the CPU.

The unit cases of ``tests/test_lockstep.py`` run through both packages'
``lockstep`` modules: no-op hooks when inactive, one scheduler at a
time, a wrong-role touch caught on either thread, a pause that ends on a
peer's checkpoint, and the same pause schedule for the same seed in both
packages.  Then the port's real worker/serving pair: a staged sync with
decode traffic in flight, under ``LockstepScheduler(seed)`` for seeds
0-2, ends with no ownership violation, with the stager's checkpoints
fired on both threads and ownership handed back to ``serve``.
"""
import threading

import numpy as np
import pytest

from repro.analysis import lockstep as jax_lockstep

from repro_torch.analysis import lockstep as torch_lockstep
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.models import init_params
from repro_torch.serving import LicensedGateway, RequestState

MODULES = {"jax": jax_lockstep, "torch": torch_lockstep}


# ---------------------------------------------------------------- unit layer
@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_hooks_are_noops_when_inactive(pkg):
    ls = MODULES[pkg]
    assert ls.active() is None
    ls.checkpoint("anything", touches=("_cursor",))
    ls.transfer_ownership(("_cursor",), "worker")
    assert ls.active() is None


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_one_scheduler_at_a_time(pkg):
    ls = MODULES[pkg]
    with ls.LockstepScheduler():
        with pytest.raises(RuntimeError, match="already active"):
            ls.LockstepScheduler().__enter__()
    assert ls.active() is None


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_serve_thread_touch_of_worker_field_raises(pkg):
    ls = MODULES[pkg]
    with ls.LockstepScheduler(max_pause_s=0.001) as sched:
        ls.transfer_ownership(("_cursor", "_pos"), "worker")
        ls.checkpoint("free_field", touches=("_other",))
        with pytest.raises(ls.LockstepViolation, match="_cursor.*owned by 'worker'"):
            ls.checkpoint("serve.read", touches=("_cursor",))
        assert len(sched.violations) == 1
        ls.transfer_ownership(("_cursor", "_pos"), "serve")
        ls.checkpoint("serve.read", touches=("_cursor",))


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_worker_thread_touch_of_serve_field_raises(pkg):
    ls = MODULES[pkg]
    caught = []

    def worker():
        try:
            ls.checkpoint("w.touch", touches=("_applied",))
        except ls.LockstepViolation as exc:
            caught.append(exc)

    with ls.LockstepScheduler(max_pause_s=0.001):
        ls.transfer_ownership(("_applied",), "serve")
        t = threading.Thread(target=worker, name="update-stager-fetch")
        t.start()
        t.join(timeout=5)
    assert len(caught) == 1 and "owned by 'serve'" in str(caught[0])


def _schedule(ls, seed):
    with ls.LockstepScheduler(seed=seed, switch_rate=0.5, max_pause_s=0.0005) as sched:
        for _ in range(40):
            ls.checkpoint("toy.a")
            ls.checkpoint("toy.b")
    return sched.pauses, dict(sched.visits)


@pytest.mark.parametrize("seed", [0, 7])
def test_pause_schedule_matches_jax(seed):
    got = _schedule(torch_lockstep, seed)
    assert got == _schedule(jax_lockstep, seed) == _schedule(torch_lockstep, seed)
    assert got[1] == {"toy.a": 40, "toy.b": 40} and 0 < got[0] < 80


def test_paused_thread_resumes_on_peer_checkpoint():
    """Every visit pauses; 400 pauses of up to 1 s finish in a few
    seconds only because each ends at the other thread's checkpoint."""
    order = []

    def peer():
        for _ in range(200):
            torch_lockstep.checkpoint("peer.tick")
        order.append("peer-done")

    with torch_lockstep.LockstepScheduler(seed=0, switch_rate=1.0, max_pause_s=1.0):
        t = threading.Thread(target=peer, name="update-stager-peer")
        t.start()
        for _ in range(200):
            torch_lockstep.checkpoint("main.tick")
        t.join(timeout=10)
    assert not t.is_alive() and order == ["peer-done"]


# ------------------------------------------------------- staged sync, seeded
MAX_PROMPT = 8


@pytest.fixture(scope="module")
def setup():
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompt(seed, n=MAX_PROMPT):
    return np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)


def _booted(cfg, params):
    server = LicenseServer(WeightStore(":memory:", row_limit=2048))
    server.publish("lm", params, tag="v1")
    server.publish_tier("lm", LicenseTier(name="free", masks={"*": ((0.0, 0.004),)}))
    gw = LicensedGateway.from_server(cfg, server, "lm", _zeros(params), device="cpu",
                                     max_batch=2, max_prompt=MAX_PROMPT, max_new_cap=16)
    return server, gw


def _zeros(x):
    if isinstance(x, dict):
        return {k: _zeros(v) for k, v in x.items()}
    return x.new_zeros(x.shape)


def _scaled(x, f):
    if isinstance(x, dict):
        return {k: _scaled(v, f) for k, v in x.items()}
    return x * f


class RoleLog(torch_lockstep.LockstepScheduler):
    """Also records which thread role reached each checkpoint."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.roles = set()

    def _visit(self, name, touches):
        self.roles.add((name, torch_lockstep._role()))
        super()._visit(name, touches)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staged_sync_clean_under_lockstep(setup, seed):
    """The port's worker/serving pair: a staged sync with decode traffic
    in flight, interleaving perturbed per seed, finishes with no
    ownership violation, and the bounded pauses never deadlock the
    bounded fetch queue."""
    cfg, params = setup
    server, gw = _booted(cfg, params)
    a = gw.submit(_prompt(1), license="free", max_new_tokens=8)
    gw.step()                                  # prefill before the publish
    server.publish("lm", _scaled(params, 1.01), tag="v2")

    with RoleLog(seed=seed, switch_rate=0.7, max_pause_s=0.005) as sched:
        assert gw.begin_sync(max_step_bytes=16 << 10) is True
        for _ in range(10_000):
            if not (gw.sync_active or gw.scheduler.running or gw.scheduler.waiting):
                break
            gw.step()
    assert sched.violations == []
    assert gw.version == gw._client.version == 2
    assert a.state == RequestState.DONE and a.version == 1

    # the harness exercised the protocol: stager checkpoints fired (the
    # fetch ones on the worker thread, the stage and flip ones on the
    # serving thread) and ownership made the full round trip
    for name, role in (("stager.fetch_parts", "worker"), ("stager.advance_pos", "worker"),
                       ("stager.stage", "serve"), ("stager.flip", "serve")):
        assert (name, role) in sched.roles, (name, role, sched.roles)
    roles = [role for role, _ in sched.transfers]
    assert "worker" in roles and roles[-1] == "serve"
    assert len(gw.audit_events("version_flip")) == 1
