"""The README's examples as the port's entry points (``repro_torch.examples``),
on the CPU, against the JAX scripts of ``examples/``: the paper-MLP
lifecycle (``quickstart``), the edge fleet's delta sync
(``edge_fleet_sync``) and ``ServingEngine`` across three archs
(``licensed_serving``).  ``tests/test_torch_examples_train.py``,
``tests/test_torch_examples_serving.py`` and
``tests/test_torch_examples_fleet.py`` hold the other five, so that
``--dist loadfile`` spreads the minutes of JAX and port runs.

Each example runs once per module at the script's own sizes, the JAX
script through ``runpy`` and the port's ``main(["--device", "cpu"])``,
each with its output captured (``_examples_harness``).  The lines they
print must be equal once the numbers that depend on the random weights
are blanked (versions, DB rows, packet entries and bytes, request and
token counts stay); the port's weight-dependent numbers must keep the
JAX script's invariants; and on the CPU no kernel launches.  Importing
any example in a fresh process leaves ``jax`` and ``repro`` unloaded.
"""
import os
import subprocess
import sys

import pytest

from _examples_harness import ROOT, masked, numbers, outputs
from repro_torch.examples import NAMES
from repro_torch.kernels import ops
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = ("quickstart", "edge_fleet_sync", "licensed_serving")


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


def test_quickstart_invariants(runs):
    """The free tier below the paid one, the paid client at the pruned
    model's accuracy, the trained MLP near the paper's ~98%, and 25
    entries in the update, as in the JAX script's own run."""
    jax_text, _, port = runs("quickstart")
    assert port["free_acc"] < port["paid_acc"] == port["pruned_acc"]
    assert port["trained_acc"] >= 0.95
    assert port["delta_entries"] == 25
    (pruned,) = numbers(r"^\[2\] pruned 80% \+ fine-tuned: acc=(\d\.\d+)", jax_text)
    paid, free = numbers(r"^\[5\] paid client acc=(\d\.\d+), free client acc=(\d\.\d+)",
                         jax_text)
    assert free < paid == pruned


def test_edge_fleet_sync_invariants(runs):
    """Every client ends at the last version; a full-license client's
    model is the server's, so all of them score alike, and the free
    tier's masked layer scores no higher."""
    _, _, port = runs("edge_fleet_sync")
    clients = port["clients"]
    assert {c["version"] for c in clients} == {4}
    full = {c["acc"] for c in clients if c["license"] == "full"}
    assert len(full) == 1
    assert all(c["acc"] <= min(full) for c in clients if c["license"] == "free")
    assert sum(s["entries"] for s in port["shards"]) <= 150


def test_licensed_serving_invariants(runs):
    """Every request gets its 6 tokens on each arch, and the free tier
    hides the share of weights the JAX script reports within a point (the
    weights are random draws from the same distribution)."""
    jax_text, _, port = runs("licensed_serving")
    for arch, got in port["archs"].items():
        assert got["tokens"] == [6, 6, 6, 6], arch
        (want,) = numbers(rf"^{arch} +served 4 reqs x 6 tok in \S+; free tier hides "
                          rf"(\d+\.\d+)% of weights", jax_text)
        assert abs(100 * got["masked_frac"] - want) < 1.0, arch


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    code = (f"import sys\nimport repro_torch.examples.{name}\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            f"assert not bad, bad\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert got.returncode == 0, got.stderr
