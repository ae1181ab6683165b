"""The README's gateway examples as the port's entry points, on the CPU,
against the JAX scripts: ``gateway_serving`` (a gateway booted from a
``LicenseServer``, a mixed-tier stream on an oversubscribed paged pool,
a shared-prefix round and a staged update mid-service) and
``chaos_sync`` (a staged sync through a 30%-fault ``ChaosTransport``,
then the license lease's walk on a frozen clock).

Each runs once per module (``_examples_harness``).  The printed lines
must be equal once the tokens, the seconds and the delta bytes (zlib
pages of the random weights) are blanked: request and token counts,
decode steps, prefills, view-cache hits, blocks, preemptions, prefix
reuse, copy-on-writes, stage steps, the versions, every wire fault,
retry and resume of the chaos run and the lease's states stay.
"""
import pytest

from _examples_harness import masked, outputs
from repro_torch.examples.gateway_serving import STREAM
from repro_torch.kernels import ops
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = ("gateway_serving", "chaos_sync")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = outputs(name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", HERE)
def test_lines_match_jax(runs, name):
    jax_text, port_text, _ = runs(name)
    assert masked(name, port_text) == masked(name, jax_text)


@pytest.mark.parametrize("name", HERE)
def test_no_kernel_launch_on_cpu(runs, name):
    _, _, port = runs(name)
    assert port["launches"] == {k: 0 for k in ops.LAUNCHES}


def test_gateway_serving_invariants(runs):
    """Every request of the stream completes its tokens; after the flip
    the gateway serves v1.1 (version 2) to new requests while the
    in-flight one stays on v1.0; the update moved bytes."""
    _, _, port = runs("gateway_serving")
    assert port["stream"]["out_tokens"] == [n for _, n in STREAM]
    up = port["update"]
    assert up["version"] == up["new_version"] == 2 and up["old_version"] == 1
    assert up["bytes_applied"] > 0 and up["steps"] > 1


def test_chaos_sync_invariants(runs):
    """The sync lands once at v2 through the faults, every fault retried,
    the in-flight requests finished on v1 with all their tokens; the
    lease walks degraded -> offline -> healthy."""
    _, _, port = runs("chaos_sync")
    sync = port["sync"]
    assert sync["version"] == 2 and sync["flips"] == sync["audit_flips"] == 1
    assert sync["faults"] > 0 and sync["retries"] == sync["audit_retries"] > 0
    assert sync["pinned"] == 1 and sync["out_tokens"] == [12, 12]
    lease = port["lease"]
    assert (lease["t11"], lease["t35"], lease["t37"]) == ("degraded", "offline", "healthy")
