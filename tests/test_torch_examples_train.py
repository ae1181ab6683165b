"""The README's LM-training example as the port's entry point
(``repro_torch.examples.train_lm_with_versioned_checkpoints``), on the
CPU, against the JAX script: 300 steps of the smoke qwen2.5-3b (vocab
512) on the synthetic stream, a delta checkpoint every 75 steps into a
row-mode ``WeightStore``, then a rollback to the first.

One file of its own, since both runs take minutes on one thread (300
steps, and four commits of ~2.2 M sqlite rows each).  The JAX script
runs in a subprocess while the port's ``main`` runs here, so the two
overlap; its output is read the same way.  The printed lines must be
equal once
the losses and the row count are blanked (checkpoint ids, payload size,
version count and the rollback stay); the port must learn, as the JAX
script's run does, and store the JAX run's rows within 1e-4 (a weight
that an AdamW step leaves unchanged stores no row).
"""
import contextlib
import io
import os
import subprocess
import sys

import pytest

from _examples_harness import ROOT, masked, numbers
from repro_torch.examples import train_lm_with_versioned_checkpoints as example
from repro_torch.kernels import ops
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

NAME = "train_lm_with_versioned_checkpoints"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX script's text, the port's text, the port's dict)."""
    where = tmp_path_factory.mktemp("train_lm")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{NAME}.py")],
                               cwd=where, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port = example.main(["--device", "cpu"])
        jax_text, jax_err = jax_run.communicate(timeout=1200)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, jax_err[-3000:]
    return jax_text, buf.getvalue(), port


def test_lines_match_jax(run):
    jax_text, port_text, _ = run
    assert masked(NAME, port_text) == masked(NAME, jax_text)


def test_no_kernel_launch_on_cpu(run):
    assert run[2]["launches"] == {k: 0 for k in ops.LAUNCHES}


def test_learns_and_checkpoints_like_jax(run):
    jax_text, _, port = run
    first, last = numbers(r"^loss: (\d+\.\d+) -> (\d+\.\d+) \(LEARNED\)", jax_text)
    assert last < first - 0.2
    assert port["learned"] and port["last_loss"] < port["first_loss"] - 0.2
    assert port["checkpoints"] == [1, 2, 3, 4] and port["production"] == 1
    (rows,) = numbers(r"^store: (\d+) rows", jax_text)
    assert abs(port["weight_rows"] - rows) <= 1e-4 * rows
