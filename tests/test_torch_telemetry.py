"""The port's observability layer against the JAX package's, on the CPU.

Three levels:

* the instruments alone: the same observations through both packages'
  ``Histogram``, ``Telemetry``, ``TraceRecorder`` and ``AuditLog`` give
  equal percentiles, identical Prometheus text, identical Chrome trace
  JSON and equal audit merges; the declared ``metrics()`` schemas are
  the same tuples and both validators accept and refuse alike;
* the gateway: ``repro.serving.LicensedGateway`` and the port's serve
  one stream (a shared prefix, tenants, a rejection, and on a 7-block
  pool three preemptions with their restarts) with the prefix cache on,
  each on its own hand-advanced clock moved by the same fixed steps, so
  every timestamp is exact.  Tokens, span names per request, the whole
  event tape (``sched:*`` events and counter tracks included), the
  audit stream, every histogram, the Chrome trace, the whole Prometheus
  page (the lease series included) and the whole ``metrics()["lease"]``
  dict must be identical, and ``metrics()`` must pass both packages'
  ``validate_gateway_metrics``.  With ``telemetry=False`` the port
  records nothing and serves the same tokens;
* a staged sync: two gateways booted ``from_server`` on one store file
  record the same ``sync_begin``, ``stager:<phase>`` events, one
  ``version_flip`` and the same ``h_stager``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.analysis import metrics as jax_metrics
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.protocol import LicenseServer as JaxLicenseServer
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway
from repro.serving import telemetry as jax_telemetry
from repro.serving import tracing as jax_tracing

from repro_torch.analysis import metrics as torch_metrics
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import telemetry as torch_telemetry
from repro_torch.serving import tracing as torch_tracing
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = {"jax": (jax_telemetry, jax_tracing, jax_metrics),
            "torch": (torch_telemetry, torch_tracing, torch_metrics)}

# the license lease's two series, registered by both slots
LEASE_SERIES = ("serving_license_lease_state", "serving_degraded_seconds_total")
# the keys of metrics()["lease"], in both packages
LEASE_STATE_KEYS = {"state", "server_attached", "ttl_s", "grace_s", "policy", "renew_age_s",
                    "degraded_seconds_total", "quarantined_versions", "pinned_views"}
# the port's one metrics() key outside the JAX schema: whether the
# decode step runs the Hopper kernels (always False on the CPU)
PORT_EXTRA = ("decode_path.kernels",)
HISTOGRAMS = ("h_ttft", "h_gap", "h_queue", "h_prefill", "h_decode", "h_stager")


class Clock:
    """Hand-advanced clock: reads ``now`` and never moves on its own."""

    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


# ------------------------------------------------------------- instruments
OBSERVATIONS = {
    "latency": ((), (3e-5, 1e-4, 7e-4, 2.5e-3, 0.04, 0.04, 0.3, 12.0, 75.0)),
    "coarse": ((1.0, 2.0, 4.0, 8.0), (0.5, 1.5, 3.0, 6.0, 20.0, 2.0)),
    "empty": ((0.1, 1.0), ()),
}


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
def test_histogram_matches_jax(case):
    buckets, values = OBSERVATIONS[case]
    got = {}
    for pkg, (tel, _, _) in PACKAGES.items():
        h = tel.Histogram("lat", **({"buckets": buckets} if buckets else {}))
        for v in values:
            h.observe(v)
        got[pkg] = (h.buckets, h.counts, h.count, h.sum, h.summary(),
                    [h.percentile(p) for p in (0, 10, 50, 75, 90, 99, 100)])
    assert got["torch"] == got["jax"]


def _registry(tel, clock):
    t = tel.Telemetry(clock=clock)
    state = {"n": 0}
    t.counter("served_total", labels={"model": "m1"}, help="reqs").inc(3)
    t.counter("pulled_total", labels={"model": 'q"x\\y'}, help="pull",
              fn=lambda: state["n"])
    t.gauge("depth", help="queue depth", fn=lambda: state["n"] * 0.5)
    t.gauge("plain")
    h = t.histogram("wait_s", buckets=(0.1, 1.0), help="waits")
    h2 = t.histogram("wait_s", buckets=(0.1, 1.0), labels={"model": "m2"})
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    h2.observe(0.1)
    t.register_collector(lambda: [("tenant_inflight", "gauge", "live", {"tenant": "a"}, 2),
                                  ("tenant_done_total", "counter", "", {"tenant": "b"}, 7)])
    t.declare("known", "nested.*")
    other = tel.Telemetry(clock=clock)
    other.counter("x_total", labels={"model": "m3"}).inc()
    t.adopt(other)
    state["n"] = 7
    return t


def test_registry_text_and_snapshot_match_jax():
    got = {pkg: _registry(tel, Clock()) for pkg, (tel, _, _) in PACKAGES.items()}
    assert got["torch"].render_prometheus() == got["jax"].render_prometheus()
    assert got["torch"].snapshot() == got["jax"].snapshot()
    assert got["torch"].declared == got["jax"].declared
    off = {pkg: tel.Telemetry(enabled=False).histogram("h")
           for pkg, (tel, _, _) in PACKAGES.items()}
    for h in off.values():
        h.observe(1.0)
    assert off["torch"].count == off["jax"].count == 0


def _tape(tr, clock):
    rec = tr.TraceRecorder(clock=clock)
    clock.now += 1.0
    rec.begin("queue", rid=0, attrs={"tier": "free"})
    clock.now += 0.5
    rec.instant("admit", rid=0, attrs={"tier": "free", "lane": 1})
    rec.end("queue", rid=0)
    rec.end("never_begun", rid=0)                 # unmatched E: dropped
    rec.begin("decode", rid=0)                    # left open: auto-closed
    rec.complete("sched:decode", clock.now, clock.now + 0.25, attrs={"batch": 2})
    rec.complete("stager:stage", clock.now + 0.25, clock.now + 0.5,
                 tid=tr.STAGER_TID, attrs={"to_version": 2})
    clock.now += 2.0
    rec.counter("queue_depth", 3)
    rec.instant("submit", rid=1)
    return rec


def test_trace_recorder_matches_jax():
    got = {pkg: _tape(tr, Clock()) for pkg, (_, tr, _) in PACKAGES.items()}
    text = {pkg: rec.chrome_trace(process_name="lm") for pkg, rec in got.items()}
    assert text["torch"] == text["jax"]
    assert got["torch"].request_events(0) == got["jax"].request_events(0)
    assert got["torch"].span_names(1) == got["jax"].span_names(1) == ["submit"]
    for pkg, (_, tr, _) in PACKAGES.items():
        assert tr.validate_chrome_trace(text["torch"]) == json.loads(text["jax"])
    merged = {pkg: tr.merge_chrome_traces([("a", got[pkg]), ("b", _tape(tr, Clock(99.0)))])
              for pkg, (_, tr, _) in PACKAGES.items()}
    assert merged["torch"] == merged["jax"]


BAD_TRACES = {
    "not_json": "not json",
    "not_array": json.dumps({"ph": "B"}),
    "unclosed": json.dumps([{"ph": "B", "ts": 0, "pid": 1, "tid": 2, "name": "x"}]),
    "unmatched_end": json.dumps([{"ph": "E", "ts": 0, "pid": 1, "tid": 2, "name": "x"}]),
    "backwards": json.dumps([{"ph": "i", "ts": 5, "pid": 1, "tid": 2, "name": "x"},
                             {"ph": "i", "ts": 4, "pid": 1, "tid": 2, "name": "y"}]),
    "no_ts": json.dumps([{"ph": "i", "pid": 1, "tid": 2, "name": "x"}]),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_validate_chrome_trace_refuses_alike(case):
    for pkg, (_, tr, _) in PACKAGES.items():
        with pytest.raises(ValueError):
            tr.validate_chrome_trace(BAD_TRACES[case])


def test_audit_log_and_merge_match_jax():
    got = {}
    for pkg, (_, tr, _) in PACKAGES.items():
        clock = Clock(10.0)
        log = tr.AuditLog(clock=clock)
        log.record("tier_grant", tier="free", model="m")
        clock.now = 12.0
        log.record("version_flip", from_version=1, to_version=2)
        other = tr.AuditLog(clock=lambda: 11.0)
        other.record("sync_begin", model="m", to_version=2)
        off = tr.AuditLog(enabled=False)
        off.record("tier_grant")
        got[pkg] = (log.events(), log.events("version_flip"), log.render_jsonl(),
                    tr.AuditLog.merge([log, other]), off.events())
    assert got["torch"] == got["jax"]
    assert [e["event"] for e in got["torch"][3]] == ["tier_grant", "sync_begin",
                                                     "version_flip"]


def test_metric_schemas_and_validators_match_jax():
    for name in ("GATEWAY_METRICS_KEYS", "FLEET_METRICS_KEYS", "FLEET_MODEL_EXTRA_KEYS",
                 "DEFAULT_LATENCY_BUCKETS"):
        assert getattr(torch_telemetry, name) == getattr(jax_telemetry, name), name
    nested = {"known": 1, "nested": {"a": 2, "b": {"c": 3}}, "empty": {}, "stray": 4}
    declared = ("known", "nested.*", "empty", "absent", "gone.*")
    for fn in ("unregistered_metric_keys", "missing_metric_keys"):
        assert getattr(torch_metrics, fn)(nested, declared) == \
            getattr(jax_metrics, fn)(nested, declared)
    assert torch_telemetry.flatten_metric_keys(nested) == \
        jax_telemetry.flatten_metric_keys(nested)
    for path in ("nested", "nested.a", "nested2", "known.x", "stray"):
        assert torch_metrics.declared_match(path, declared) == \
            jax_metrics.declared_match(path, declared)
    for tel, _, _ in PACKAGES.values():
        with pytest.raises(AssertionError, match="unregistered"):
            tel.validate_gateway_metrics({"stray": 1})
        with pytest.raises(AssertionError, match="missing"):
            tel.validate_gateway_metrics({"admitted": 1})


# ---------------------------------------------------------------- gateways
FREE = {"*": ((0.0, 0.01),)}
# a 7-block pool of 4-token blocks: the stream preempts and restarts
GEOMETRY = dict(max_batch=2, max_lanes=4, max_prompt=8, max_new_cap=8,
                block_size=4, num_blocks=7)
SUBMIT_DT = 0.0625
STEP_DT = 0.25


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _stream():
    """(tier, prompt, max_new_tokens, tenant): a 4-token shared head and
    own tails of 2-4 tokens, two tiers, two tenants and tenant-less."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, 500, 4, dtype=np.int32)
    out = []
    for i in range(5):
        tail = rng.integers(0, 500, 4 - i % 3, dtype=np.int32)
        out.append(("free" if i % 2 else "full", np.concatenate([head, tail]),
                    5 + 2 * (i % 2), (None, "acme", "beta")[i % 3]))
    return out


def _drive(gw, clock):
    """Submit the stream (and one over-long prompt, rejected) a fixed
    clock step apart, then step to the drain, a fixed step apart."""
    reqs = []
    for tier, prompt, new, tenant in _stream():
        reqs.append(gw.submit(prompt, license=tier, max_new_tokens=new, tenant=tenant))
        clock.now += SUBMIT_DT
    reqs.append(gw.submit(np.arange(20, dtype=np.int32), tenant="acme"))
    steps = 0
    while gw.scheduler.waiting or gw.scheduler.running:
        gw.step()
        clock.now += STEP_DT
        steps += 1
    assert steps < 200
    return reqs


def _pair(weights, **kw):
    jcfg, jparams, cfg, params = weights
    jclock, tclock = Clock(), Clock()
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     clock=jclock, **GEOMETRY, **kw)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          clock=tclock, device="cpu", **GEOMETRY, **kw)
    return jgw, _drive(jgw, jclock), tgw, _drive(tgw, tclock)


@pytest.fixture(scope="module")
def served(weights):
    return _pair(weights)


def test_stream_exercises_every_path(served):
    jgw, jreqs, tgw, treqs = served
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
    assert treqs[-1].state == RequestState.REJECTED
    assert all(r.state == RequestState.DONE for r in treqs[:-1])
    assert tgw.stats["preempted"] > 0 and tgw.stats["prefix_tokens_reused"] > 0
    assert tgw.stats["cow_copies"] > 0
    assert tgw.stats["resident_decode_steps"] == tgw.stats["decode_steps"]


def test_spans_per_request_identical(served):
    jgw, jreqs, tgw, treqs = served
    for jr, tr in zip(jreqs, treqs):
        assert tgw.tracer.span_names(tr.rid) == jgw.tracer.span_names(jr.rid), jr.rid
    for r in treqs[:-1]:
        names = tgw.tracer.span_names(r.rid)
        for span in ("submit", "queue", "admit", "prefill", "prefill_chunk",
                     "decode", "decode_step", "finish"):
            assert span in names, (r.rid, span, names)
        assert names.count("preempt") == names.count("restart") == r.preemptions
    assert tgw.tracer.span_names(treqs[-1].rid) == ["reject"]


def test_event_tape_identical(served):
    """The whole tape: lifecycle events, ``sched:*`` complete events and
    the counter tracks, timestamps included."""
    jgw, _, tgw, _ = served
    tape = list(tgw.tracer.events)
    assert tape == list(jgw.tracer.events)
    sched = [e for e in tape if e[1] == "X"]
    assert {e[3] for e in sched} == {"sched:prefill", "sched:decode"}
    assert {e[3] for e in tape if e[1] == "C"} == {"queue_depth", "running",
                                                   "blocks_held"}
    # one per executed action, and one per decode whose whole batch was
    # preempted (it executed nothing, so the schedule trace skips it)
    assert len(sched) == len(tgw.trace) + sum(
        e[4]["batch"] == 0 for e in sched) >= len(tgw.trace)


def test_audit_stream_identical(served):
    jgw, _, tgw, _ = served
    assert tgw.audit_events() == jgw.audit_events()
    assert [e["event"] for e in tgw.audit_events()] == \
        ["tier_grant", "tier_grant", "view_materialize", "view_materialize"]


@pytest.mark.parametrize("name", HISTOGRAMS)
def test_histogram_identical(served, name):
    jgw, _, tgw, _ = served
    j, t = getattr(jgw, name), getattr(tgw, name)
    assert (t.name, t.labels, t.counts, t.count, t.sum) == \
        (j.name, j.labels, j.counts, j.count, j.sum)


def test_histogram_counts(served):
    _, _, tgw, treqs = served
    done = [r for r in treqs if r.state == RequestState.DONE]
    assert tgw.h_ttft.count == tgw.h_queue.count == len(done)   # once each, ever
    decodes = [e for e in tgw.tracer.events if e[3] == "sched:decode"]
    assert tgw.h_decode.count == len(decodes) >= tgw.stats["decode_steps"]
    assert tgw.h_prefill.count == tgw.stats["prefill_chunks"]
    assert tgw.h_stager.count == 0
    # every gap is a whole number of steps on the hand clock
    assert tgw.h_gap.sum == pytest.approx(STEP_DT * round(tgw.h_gap.sum / STEP_DT))


def test_prometheus_identical_but_the_lease_series(served):
    """The whole page is identical now, the two lease series included
    (the name is the one this test had while the lease was unported)."""
    jgw, _, tgw, _ = served
    page = tgw.render_prometheus()
    assert page == jgw.render_prometheus()
    lease = [ln for ln in page.splitlines() if any(s in ln for s in LEASE_SERIES)]
    assert len(lease) == 3 * len(LEASE_SERIES)      # HELP, TYPE, one sample


def test_chrome_trace_identical_and_valid(served):
    jgw, _, tgw, _ = served
    text = tgw.chrome_trace()
    assert text == jgw.chrome_trace()
    events = jax_tracing.validate_chrome_trace(text)
    assert any(e["name"].startswith("sched:") for e in events)
    assert any(e["ph"] == "C" for e in events)


def test_metrics_schema_and_values(served):
    jgw, _, tgw, _ = served
    jm, tm = jgw.metrics(), tgw.metrics()
    torch_telemetry.validate_gateway_metrics(tm, extra=PORT_EXTRA)
    jax_telemetry.validate_gateway_metrics(tm, extra=PORT_EXTRA)
    with pytest.raises(AssertionError, match="decode_path.kernels"):
        jax_telemetry.validate_gateway_metrics(tm)
    assert set(tm["lease"]) == set(jm["lease"]) == LEASE_STATE_KEYS
    assert tm["lease"] == jm["lease"]
    assert tm["decode_path"] == {**jm["decode_path"], "kernels": False}
    for key in set(jm) - {"decode_path"}:
        assert tm[key] == jm[key], key
    assert tm["tenants"] == {"acme": {"inflight": 0, "queued": 0, "completed": 2,
                                      "tokens_generated": 12, "blocks_held": 0},
                             "beta": {"inflight": 0, "queued": 0, "completed": 1,
                                      "tokens_generated": 5, "blocks_held": 0}}
    assert torch_metrics.unregistered_metric_keys(
        tm, list(tgw.telemetry.declared) + list(PORT_EXTRA)) == []


def test_telemetry_off_records_nothing(weights, served):
    _, jreqs, _, _ = served
    _, _, cfg, params = weights
    clock = Clock()
    gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                         clock=clock, device="cpu", telemetry=False, **GEOMETRY)
    reqs = _drive(gw, clock)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert not gw.obs and len(gw.tracer.events) == 0 and gw.audit_events() == []
    assert all(getattr(gw, h).count == 0 for h in HISTOGRAMS)
    torch_telemetry.validate_gateway_metrics(gw.metrics(), extra=PORT_EXTRA)
    assert all(r._open_span is None for r in reqs)


def test_shared_registry_across_slots(weights):
    """A shared ``Telemetry`` takes each slot's instruments under its
    model label, as a fleet's does."""
    _, _, cfg, params = weights
    shared = torch_telemetry.Telemetry()
    gws = [LicensedGateway(cfg, params, device="cpu", telemetry=shared, model=m,
                           max_batch=1, max_prompt=4, max_new_cap=2, block_size=4)
           for m in ("a", "b")]
    for gw in gws:
        gw.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=2)
        gw.run()
    text = shared.render_prometheus()
    for m in ("a", "b"):
        assert f'serving_tokens_generated_total{{model="{m}"}} 2' in text
    assert text.count("# TYPE serving_ttft_seconds histogram") == 1


def test_serve_entry_point_writes_observability(tmp_path, capsys):
    from repro_torch.launch import serve

    out = {k: tmp_path / f"{k}.out" for k in ("prom", "trace", "audit")}
    serve.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3",
                "--prometheus-out", str(out["prom"]), "--trace-out", str(out["trace"]),
                "--audit-out", str(out["audit"])])
    assert "ttft p99" in capsys.readouterr().out
    assert "serving_tokens_generated_total" in out["prom"].read_text()
    jax_tracing.validate_chrome_trace(out["trace"].read_text())
    audit = [json.loads(ln) for ln in out["audit"].read_text().splitlines()]
    assert {e["event"] for e in audit} == {"tier_grant", "view_materialize"}
    serve.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--batch", "1",
                "--prompt-len", "4", "--new-tokens", "2", "--no-telemetry",
                "--audit-out", "-"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and '"event"' not in out   # no audit


# ------------------------------------------------------------- staged sync
SYNC_GEOMETRY = dict(max_batch=2, max_prompt=8, max_new_cap=16)


def _nested(flat):
    out = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _synced(path, weights):
    """Both packages' gateways booted from one store file, a request in
    flight, v2 published and staged to its flip on the hand clock."""
    jcfg, jparams, cfg, _ = weights
    jflat = jax_flatten_params(jax.device_get(jparams))
    jserver = JaxLicenseServer(JaxWeightStore(path, row_limit=2048))
    jserver.publish("lm", _nested(jflat), tag="v1")
    jserver.publish_tier("lm", JaxLicenseTier(name="free", masks={"*": ((0.0, 0.004),)}))
    tserver = LicenseServer(WeightStore(path, row_limit=2048))
    zeros = {k: np.zeros_like(v) for k, v in jflat.items()}
    clocks = (Clock(), Clock())
    gws = (JaxGateway.from_server(jcfg, jserver, "lm", _nested(zeros), clock=clocks[0],
                                  **SYNC_GEOMETRY),
           LicensedGateway.from_server(cfg, tserver, "lm",
                                       params_from_jax(zeros, device="cpu"),
                                       clock=clocks[1], device="cpu", **SYNC_GEOMETRY))
    prompt = np.random.default_rng(1).integers(0, 500, 8, dtype=np.int32)
    reqs = []
    for gw, clock in zip(gws, clocks):
        reqs.append(gw.submit(prompt, license="free", max_new_tokens=10))
        gw.step()
        clock.now += STEP_DT
    jserver.publish("lm", _nested({k: v * np.float32(1.01) for k, v in jflat.items()}),
                    tag="v2")
    for gw, clock in zip(gws, clocks):
        assert gw.begin_sync(max_step_bytes=1 << 20) is True
        while gw.sync_active or gw.scheduler.running or gw.scheduler.waiting:
            gw.step()
            clock.now += STEP_DT
    return gws, reqs


@pytest.fixture(scope="module")
def synced(tmp_path_factory, weights):
    return _synced(str(tmp_path_factory.mktemp("sync") / "lm.db"), weights)


def test_staged_sync_records_match_jax(synced):
    (jgw, tgw), (jr, tr) = synced
    assert tr.out_tokens == jr.out_tokens and tr.version == 1 and tgw.version == 2
    assert tgw.audit_events() == jgw.audit_events()
    events = [e["event"] for e in tgw.audit_events()]
    assert events.count("sync_begin") == events.count("version_flip") == 1
    flip = tgw.audit_events("version_flip")[0]
    assert (flip["from_version"], flip["to_version"]) == (1, 2)
    stager = [e for e in tgw.tracer.events if e[3].startswith("stager:")]
    assert stager == [e for e in jgw.tracer.events if e[3].startswith("stager:")]
    assert [e[2] for e in stager] == [-1 - torch_tracing.STAGER_TID] * len(stager)
    assert {e[3] for e in stager} == {"stager:stage", "stager:prewarm", "stager:flip"}
    assert tgw.h_stager.count == jgw.h_stager.count == len(stager) \
        == tgw.metrics()["staged_update"]["steps"]
    assert tgw.h_stager.counts == jgw.h_stager.counts
    jax_tracing.validate_chrome_trace(tgw.chrome_trace())


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import repro_torch.serving, repro_torch.analysis\n"
            "import repro_torch.analysis.sanitize, repro_torch.analysis.lockstep\n"
            "import repro_torch.analysis.metrics\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
