"""The port's staged weight sync against the JAX package's, on the CPU.

A JAX gateway (``prefix_cache=False, telemetry=False``) and the port's
are booted ``from_server`` on ONE store file (each package's
``LicenseServer`` over its own connection), get the same requests, and
sync to the same v2 mid-stream.  Everything observable must agree:
greedy tokens and pinned versions per request, the scheduler trace, the
stager's stats (steps, parts, bytes, requantized layers, prewarmed
views, wire counters), the view cache's counters and the client's
downloaded bytes — in float and int8 (materialized views, and the
in-scan dequant of the store with the tier's intervals), with the
background fetch worker on and off.  The failure paths (an aborted
staging, quarantine) and the atomic tier-and-version flip are replayed
the same way.  The two frameworks sum logits in different orders
(~1e-6 apart in f32), which moves no argmax at these weights.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.protocol import LicenseServer as JaxLicenseServer
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.pytree_io import flatten_params
from repro_torch.core.weightstore import WeightStore
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving.quantized import quantize_serving_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GEOMETRY = dict(max_batch=2, max_prompt=8, max_new_cap=16)
OLD_MASKS = ((0.0, 0.004),)
NEW_MASKS = ((0.0, 0.01),)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jflat = jax_flatten_params(jax.device_get(
        jax_init_params(jax.random.PRNGKey(0), jcfg)))
    return jcfg, jflat, smoke_variant(get_config("qwen2.5-3b"))


def _nested(flat):
    out = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


class Pair:
    """One store file, a server per package over it, and a gateway per
    package booted from it."""

    def __init__(self, path, weights, **kw):
        self.jcfg, self.jflat, self.cfg = weights
        self.jserver = JaxLicenseServer(JaxWeightStore(path, row_limit=2048))
        self.jserver.publish("lm", _nested(self.jflat), tag="v1")
        self.jserver.publish_tier("lm", JaxLicenseTier(name="free",
                                                       masks={"*": OLD_MASKS}))
        self.tserver = LicenseServer(WeightStore(path, row_limit=2048))
        jtemplate = _nested({k: np.zeros_like(v) for k, v in self.jflat.items()})
        ttemplate = params_from_jax({k: np.zeros_like(v) for k, v in self.jflat.items()},
                                    device="cpu")
        self.jgw = JaxGateway.from_server(self.jcfg, self.jserver, "lm", jtemplate,
                                          prefix_cache=False, telemetry=False,
                                          **GEOMETRY, **kw)
        self.tgw = LicensedGateway.from_server(self.cfg, self.tserver, "lm", ttemplate,
                                               prefix_cache=False, device="cpu",
                                               **GEOMETRY, **kw)

    @property
    def both(self):
        return (self.jgw, self.tgw)

    def publish(self, flat, tag):
        return self.jserver.publish("lm", _nested(flat), tag=tag)

    def scaled(self, factor):
        return {k: np.asarray(v) * np.float32(factor) for k, v in self.jflat.items()}


def _prompt(seed, n=8):
    return np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)


def _same_state(pair):
    jgw, tgw = pair.both
    assert list(tgw.trace) == list(jgw.trace)
    assert tgw.views.stats() == jgw.views.stats()
    assert tgw.version == jgw.version
    assert tgw._client.bytes_downloaded == jgw._client.bytes_downloaded
    jst, tst = jgw.metrics()["staged_update"], tgw.metrics()["staged_update"]
    assert tst == jst
    for key in ("sync_retries", "sync_timeouts", "sync_quarantines", "completed",
                "tokens_generated", "rejected"):
        assert tgw.stats[key] == jgw.stats[key], key
    return tst


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.tobytes()


@pytest.mark.parametrize("background_fetch", [True, False])
@pytest.mark.parametrize("quantized", [False, True, "in_scan"])
def test_midstream_staged_sync_matches_jax(tmp_path, weights, quantized,
                                           background_fetch):
    """Requests in flight across the sync stay on v1 with the JAX tokens;
    the flip lands on the same step with the hot tier prewarmed; a request
    after it is served on v2 through that view (no miss); the port's v1
    tensors are untouched (copy-on-apply).  ``quantized``: materialized
    int8 views (True) or the in-scan dequant ("in_scan")."""
    _midstream_sync(tmp_path, weights, quantized, background_fetch)


@pytest.fixture(scope="module")
def recurrent_weights():
    """recurrentgemma-2b's smoke variant at 5 layers: one (rec, rec, attn)
    unit and two tail blocks, whose rank-2 leaves travel in the delta."""
    jcfg = jax_smoke_variant(jax_get_config("recurrentgemma-2b")).replace(num_layers=5)
    jflat = jax_flatten_params(jax.device_get(
        jax_init_params(jax.random.PRNGKey(0), jcfg)))
    return jcfg, jflat, smoke_variant(get_config("recurrentgemma-2b")).replace(num_layers=5)


@pytest.mark.parametrize("quantized", [True, "in_scan"])
def test_recurrent_midstream_staged_sync_matches_jax(tmp_path, recurrent_weights, quantized):
    """The same sync on recurrentgemma-2b (the paged pool with RG-LRU
    lane state, the bucket prefill, the gather/scatter decode) from an
    int8 store: the tail blocks' rank-2 leaves are in the delta and in
    ``requantize_layers``, and the tokens before and after the flip are
    the JAX gateway's."""
    st = _midstream_sync(tmp_path, recurrent_weights, quantized, False,
                         max_step_bytes=16 << 20)
    # every leaf the 1.01 scale changes (the zero conv biases stay), tail ones included
    assert st["layers_touched"] == sum(1 for v in recurrent_weights[1].values() if np.any(v))


def _midstream_sync(tmp_path, weights, quantized, background_fetch, max_step_bytes=1 << 20):
    mode = ({} if not quantized else dict(quantized=True) if quantized == "in_scan"
            else dict(quantized=True, materialize_int8_views=True))
    pair = Pair(str(tmp_path / "lm.db"), weights, **mode)
    v1_params = {k: v.clone() for k, v in flatten_params(pair.tgw._client.params).items()}
    v1_refs = flatten_params(pair.tgw._client.params)
    inflight = [[gw.submit(_prompt(s), license="free", max_new_tokens=16)
                 for s in (1, 2)] for gw in pair.both]
    for gw in pair.both:
        gw.step()
    pair.publish(pair.scaled(1.01), "v2")
    kw = dict(max_step_bytes=max_step_bytes, requant_layers_per_step=6,
              background_fetch=background_fetch)
    assert all(gw.begin_sync(**kw) for gw in pair.both)
    flips = []
    for gw in pair.both:
        steps = 0
        while gw.sync_active or gw.scheduler.waiting or gw.scheduler.running:
            gw.step()
            steps += 1
            if not gw.sync_active and len(flips) < (gw is pair.tgw) + 1:
                flips.append((steps, gw.version, ("free", gw.version) in gw.views))
    assert flips[0] == flips[1] and flips[1][1] == 2 and flips[1][2]
    for jr, tr in zip(*inflight):
        assert tr.state == RequestState.DONE and tr.version == jr.version == 1
        assert tr.out_tokens == jr.out_tokens
    st = _same_state(pair)
    assert st["flips"] == 1 and st["views_prewarmed"] == 1 and st["steps"] > 3
    if quantized:
        assert st["layers_requantized"] == st["layers_touched"] > 0
        full = flatten_params(quantize_serving_params(pair.tgw._client.params))
        for k, v in flatten_params(pair.tgw._weights[2]).items():
            assert torch.equal(v, full[k]), k
    for k, v in v1_refs.items():
        assert torch.equal(v, v1_params[k]), k
    jnew = jax_flatten_params(pair.jgw._client.params)
    for k, v in flatten_params(pair.tgw._client.params).items():
        assert _bits(v) == _bits(jnew[k]), k
    misses = pair.tgw.views.misses
    after = [gw.submit(_prompt(3), license="free", max_new_tokens=3) for gw in pair.both]
    for gw in pair.both:
        gw.run()
    assert after[1].version == after[0].version == 2
    assert after[1].out_tokens == after[0].out_tokens
    assert pair.tgw.views.misses == misses
    return st


def test_atomic_tier_and_version_flip_matches_jax(tmp_path, weights):
    """A tier redefinition published with the version bump goes live in
    the stager step that installs the weights: at every step boundary the
    gateway is fully old or fully new, and mid-staging admissions pin the
    old version.  A request still in flight on the redefined tier at the
    flip defers the change and refuses new admissions to the tier until
    it drains — step for step as in the JAX package."""
    pair = Pair(str(tmp_path / "lm.db"), weights)
    longs = [gw.submit(_prompt(1), license="free", max_new_tokens=16) for gw in pair.both]
    for gw in pair.both:
        gw.step()
    pair.publish(pair.scaled(1.01), "v2")
    pair.jserver.publish_tier("lm", JaxLicenseTier(name="free", masks={"*": NEW_MASKS}))
    records = []
    for gw in pair.both:
        assert gw.begin_sync(max_step_bytes=512 << 10) is True
        rec = []
        while gw.sync_active:
            gw.step()
            tier_new = gw.tiers["free"].masks == {"*": NEW_MASKS}
            rec.append((tier_new, gw.version, len(gw._pending_tiers)))
            if gw.sync_active:
                rec.append(gw.submit(_prompt(5), license="full",
                                     max_new_tokens=1).version)
        rej = gw.submit(_prompt(2), license="free", max_new_tokens=1)
        rec.append((rej.state.value, "redefined" in (rej.error or "")))
        gw.run()
        rec.append(gw.tiers["free"].masks == {"*": NEW_MASKS})
        ok = gw.submit(_prompt(3), license="free", max_new_tokens=2)
        gw.run()
        rec.append((ok.state.value, ok.version, tuple(ok.out_tokens)))
        records.append(rec)
    assert records[1] == records[0]
    states = [x for x in records[1] if isinstance(x, tuple) and len(x) == 3]
    assert not any(tier_new and v == 1 for tier_new, v, _ in states)
    assert states[-1][1] == 2 and len(states) > 2
    assert {x for x in records[1] if type(x) is int} == {1}   # mid-staging pins
    assert ("rejected", True) in records[1] and records[1][-2] is True
    assert longs[1].out_tokens == longs[0].out_tokens and longs[1].version == 1
    _same_state(pair)


def test_failed_staging_aborts_clean_and_quarantines(tmp_path, weights):
    """A v2 naming a layer the client never had: the stage step raises
    KeyError, the session tears down (no staged version left, phase
    failed), serving continues on v1, and after ``quarantine_after``
    failed attempts v2 is quarantined — begin_sync refuses it until the
    operator clears it.  Same counters and phases as the JAX gateway."""
    pair = Pair(str(tmp_path / "lm.db"), weights, quarantine_after=2)
    rogue = dict(pair.scaled(1.01))
    rogue["rogue/kernel"] = np.ones((4, 4), np.float32)
    pair.publish(rogue, "v2")
    seen = []
    for gw in pair.both:
        rec = []
        for attempt in range(3):
            started = gw.begin_sync(max_step_bytes=1 << 30)
            rec.append(started)
            if not started:
                break
            with pytest.raises(KeyError, match="rogue/kernel"):
                while gw.sync_active:
                    gw.step()
            st = gw.metrics()["staged_update"]
            rec.append((st["phase"], gw.version, gw._staging_version,
                        sorted(gw._weights), sorted(gw.quarantined_versions)))
            r = gw.submit(_prompt(attempt), license="free", max_new_tokens=2)
            gw.run()
            rec.append((r.state.value, r.version, tuple(r.out_tokens)))
        gw.clear_quarantine(2)
        rec.append(gw.begin_sync(max_step_bytes=1 << 30))
        with pytest.raises(KeyError):
            gw.sync_step()
        seen.append(rec)
    assert seen[1] == seen[0]
    assert seen[1][0] is True and seen[1][-2] is False and seen[1][-1] is True
    assert ("failed", 1, None, [1], [2]) in seen[1]
    _same_state(pair)
    assert pair.tgw.stats["sync_quarantines"] == 1
