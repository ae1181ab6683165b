"""The README's fleet examples as the port's entry points, on the CPU,
against the JAX scripts: ``fleet_serving`` (three heterogeneous smoke
models under one cache budget, two tenants with quotas, a revocation
mid-flight) and ``observability`` (a server-synced slot and a plain one
through a staged flip, then the trace tape, Prometheus, the audit stream
and the Chrome trace).

Each runs once per module (``_examples_harness``).  The printed lines
must be equal once the seconds and the host-clock latencies are
blanked: completions, rejections and their reasons, tokens, steps, cache
bytes, tenant counters, a request's span story, the audit events (view
fingerprints too: they hash the tier, not the weights) and the trace's
event count stay.
"""
import json

import pytest

from _examples_harness import masked, outputs
from repro_torch.kernels import ops
from repro_torch.serving import validate_chrome_trace
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = ("fleet_serving", "observability")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            where = tmp_path_factory.mktemp(name)
            cache[name] = (*outputs(name, where), where)
        return cache[name]

    return get


@pytest.mark.parametrize("name", HERE)
def test_lines_match_jax(runs, name):
    jax_text, port_text, _, _ = runs(name)
    assert masked(name, port_text) == masked(name, jax_text)


@pytest.mark.parametrize("name", HERE)
def test_no_kernel_launch_on_cpu(runs, name):
    port = runs(name)[2]
    assert port["launches"] == {k: 0 for k in ops.LAUNCHES}


def test_fleet_serving_invariants(runs):
    """Every admitted request completes its tokens; the two quota
    rejections at submit get none; the revoked tenant's decoding request
    drains and the queued one is rejected."""
    port = runs("fleet_serving")[2]
    assert port["out_tokens"] == [6, 4, 6, 0, 0]
    assert port["revoked"]["live"] == "done" and port["revoked"]["live_tokens"] == 8
    assert port["revoked"]["queued"] == "rejected"


def test_observability_invariants(runs):
    """Three requests done across the flip to version 2; the Chrome trace
    the port wrote parses and holds the events it reports."""
    _, _, port, where = runs("observability")
    assert port["done"] == 3 and port["version"] == 2
    trace = (where / "obs_trace.json").read_text()
    assert len(validate_chrome_trace(trace)) == port["trace_events"]
    assert json.loads(trace)
