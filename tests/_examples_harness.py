"""Run an example of ``examples/`` (the JAX scripts) and its port in
``repro_torch.examples`` on the CPU, and compare what they print.

``outputs(name, where)`` runs the JAX script through ``runpy`` and the
port's ``main(["--device", "cpu"])``, each with its standard output
captured and the working directory set to ``where`` (the observability
example writes its Chrome trace there); it returns (the JAX script's
text, the port's text, the port's returned dict).  ``masked(name,
text)`` blanks the numbers that depend on the random weights or the
clock (the JAX PRNG cannot be reproduced in torch), so the lines left
must be equal.
"""
import contextlib
import importlib
import io
import os
import re
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SECONDS = (r"in \d+\.\d+s", "in *s")
TOKENS = (r"\[[\d, ]+\]$", "[*]")
MASKS = {
    "quickstart": [(r"acc=\d\.\d+", "acc=*"), (r"accuracy \d\.\d+ after \d+", "accuracy * after *")],
    "edge_fleet_sync": [(r"acc=\d\.\d+", "acc=*")],
    "train_lm_with_versioned_checkpoints": [(r"loss: \d+\.\d+ -> \d+\.\d+", "loss: * -> *"),
                                            (r"store: \d+ rows", "store: * rows")],
    "licensed_serving": [SECONDS, TOKENS, (r"hides \d+\.\d+%", "hides *%")],
    "gateway_serving": [SECONDS, TOKENS, (r"\(\d+ delta bytes", "(* delta bytes")],
    "fleet_serving": [SECONDS],
    "observability": [(r"ttft p50/p99: [\d.]+/[\d.]+ ms", "ttft p50/p99: */* ms"),
                      (r"(serving_ttft_seconds_bucket\{[^}]*\}) \d+", r"\1 *")],
    "chaos_sync": [],
}


def masked(name, text):
    """``text``'s lines with the weight- and clock-dependent numbers
    blanked; a training log's ``step`` lines (losses and times) dropped."""
    out = []
    for line in text.splitlines():
        if line.startswith("step "):
            continue
        for pattern, repl in MASKS[name]:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return out


def _captured(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return buf.getvalue(), result


def outputs(name, where):
    """(JAX script's text, the port's text, the port's dict), both run in
    ``where``."""
    script = ROOT / "examples" / f"{name}.py"
    cwd, argv = os.getcwd(), sys.argv
    os.chdir(where)
    try:
        sys.argv = [str(script)]
        jax_text, _ = _captured(lambda: runpy.run_path(str(script), run_name="__main__"))
        module = importlib.import_module(f"repro_torch.examples.{name}")
        port_text, port = _captured(lambda: module.main(["--device", "cpu"]))
    finally:
        os.chdir(cwd)
        sys.argv = argv
    return jax_text, port_text, port


def numbers(pattern, text):
    """The groups of ``pattern``'s first match in ``text``, as floats."""
    m = re.search(pattern, text, re.M)
    assert m, f"{pattern!r} not in {text!r}"
    return [float(g) for g in m.groups()]
