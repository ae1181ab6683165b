"""The port's static lint (``repro_torch.analysis.lint``) against the JAX
package's (``repro.analysis.lint``), and its two rules in PyTorch and
CUDA terms, on tmp fixture trees.

* The copied rules (clock, obs, guarded-by, metrics): on identical
  fixture trees, the port's lint renders the same diagnostics as the
  JAX package's, rule by rule; each bad fixture trips its rule.
* RULE-HOT-PATH: each host copy or fence flags its bad fixture at its
  line, and the sanctioned sites (a copy outside any loop, a copy in a
  loop's header even inside an outer step loop, host->device staging,
  numpy casts, out-of-scope files) pass.
* RULE-KERNEL: a wrapper without a plain version, an unbound extension
  function, a dead ``m.def``, and a ``try`` that falls back to ``ref``
  or the CPU are flagged; a paired, bound wrapper that lets its failure
  raise is clean; exempt files and ``// lint: allow-kernel`` pass.
* The port's own tree lints clean with no suppression under
  ``serving/``; the JAX lint over ``src/`` stays clean with the new
  modules in it; the CLI's exit codes and default path; importing and
  running the linter loads neither ``jax`` nor ``torch``.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as jax_lint
from repro.analysis.rules import ALL_RULES as JAX_RULES

from repro_torch.analysis import lint
from repro_torch.analysis.rules import ALL_RULES
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _write(root: Path, files) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def _diags(root, rule):
    rules = [r for r in ALL_RULES if r.name == rule]
    assert rules, f"unknown rule {rule}"
    return lint.run_paths([root], rules)


# ------------------------------------------------------ the copied rules
COPIED = {
    "clock_bad": ("clock", {"serving/gateway.py": (
        "import time\n"
        "def wait():\n"
        "    t0 = time.monotonic()\n"
        "    time.sleep(0.1)\n"
        "    return t0\n")}),
    "clock_injected": ("clock", {"serving/gateway.py": (
        "import time\n"
        "def make(clock=time.perf_counter):\n"
        "    return clock()\n"), "training/loop.py": "import time\nt = time.time()\n"}),
    "clock_suppression_bad": ("clock", {"serving/gateway.py": (
        "import time\n"
        "t0 = time.monotonic()  # lint: allow-clock\n"
        "# lint: allow-clock\n"
        "t1 = time.monotonic()\n"
        "t2 = time.monotonic()\n")}),
    "obs_bad": ("obs", {"serving/fleet.py": (
        "class G:\n"
        "    def step(self):\n"
        "        self.tracer.begin('step', 1)\n"
        "        self.h.observe(0.5)\n"
        "        self.audit.record('flip', v=2)\n")}),
    "obs_guarded": ("obs", {"serving/fleet.py": (
        "class G:\n"
        "    def step(self):\n"
        "        if self.obs:\n"
        "            self.tracer.begin('step', 1)\n"
        "    def emit(self):\n"
        "        if not self.obs:\n"
        "            return\n"
        "        self.h.observe(0.5)\n"
        "    def reg(self):\n"
        "        if self.audit is not None:\n"
        "            self.audit.record('grant', t='free')\n"),
        "serving/tracing.py": "class T:\n    def f(self):\n        self.tracer.end(1)\n"}),
    "guarded_by_bad": ("guarded-by", {"serving/updates.py": (
        "class S:\n"
        "    def __init__(self):\n"
        "        self._counts = {}  # guarded-by: _lock\n"
        "        self._pos = (0, 0)  # guarded-by: owner(__init__, begin)\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self._counts = {}\n"
        "    def begin(self):\n"
        "        self._pos = (1, 0)\n"
        "    def bad(self):\n"
        "        self._counts = {}\n"
        "        old, self._pos = self._pos, None\n"
        "        return old\n")}),
    "metrics_bad": ("metrics", {
        "docs/OBSERVABILITY.md": (
            "# Observability\n"
            "| `serving_requests_{admitted,rejected}_total` | counter |\n"
            "| `serving_phantom_total` | counter |\n"),
        "serving/fleet.py": (
            "class M:\n"
            "    def reg(self, t):\n"
            "        t.counter('serving_requests_admitted_total')\n"
            "        t.counter('serving_requests_rejected_total')\n"
            "        t.counter('serving_undocumented_total')\n"
            "TABLE = [('ghost', 'serving_requests_admitted_total', 'x')]\n"),
        "serving/telemetry.py": "GATEWAY_METRICS_KEYS = ('admitted', 'rejected', 'admitted')\n"}),
    "metrics_clean": ("metrics", {
        "docs/OBSERVABILITY.md": "| `serving_requests_{admitted,rejected}_total` | c |\n",
        "serving/fleet.py": (
            "def reg(t):\n"
            "    t.counter('serving_requests_admitted_total')\n"
            "    t.counter('serving_requests_rejected_total')\n")}),
}


@pytest.mark.parametrize("case", sorted(COPIED))
def test_copied_rules_render_as_the_jax_lint(tmp_path, case, monkeypatch):
    """Both linters on one fixture tree, the rule alone and every rule:
    the same rendered diagnostics; a ``_bad`` fixture trips its rule."""
    rule, files = COPIED[case]
    root = _write(tmp_path / "tree", files)
    monkeypatch.chdir(tmp_path)
    got = lint.render(lint.run_paths([root], [r for r in ALL_RULES if r.name == rule]))
    want = jax_lint.render(jax_lint.run_paths([root], [r for r in JAX_RULES if r.name == rule]))
    assert got == want
    assert (f"RULE-{rule.upper()}" in got) == case.endswith("_bad")
    copied = {"clock", "obs", "guarded-by", "metrics"}
    assert lint.render([d for d in lint.run_paths([root]) if d.rule in copied]) == \
        jax_lint.render([d for d in jax_lint.run_paths([root]) if d.rule in copied])


def test_copied_rule_registry():
    assert [r.name for r in ALL_RULES] == [r.name for r in JAX_RULES] == \
        ["clock", "obs", "guarded-by", "hot-path", "kernel", "metrics"]


# ----------------------------------------------------------- RULE-HOT-PATH
_LOOP = (
    "import numpy as np\n"
    "import torch\n"
    "def step(xs, ev):\n"
    "    for x in xs:\n"
    "        y = {expr}\n"
    "    return y\n")

HOT_BAD = {
    "item": "x.item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.detach().numpy()",
    "to_cpu": 'x.to("cpu")',
    "to_device_cpu": 'x.to(device="cpu", dtype=torch.float32)',
    "to_torch_device_cpu": 'x.to(torch.device("cpu"))',
    "int_of_torch": "int(torch.argmax(x))",
    "float_of_method": "float(x.float().sum())",
    "bool_of_method": "bool(x.to(torch.bool).any())",
    "np_asarray": "np.asarray(x.detach())",
    "np_array": "np.array(torch.stack([x]))",
    "comprehension": "[t.item() for t in x]",
}


@pytest.mark.parametrize("name", sorted(HOT_BAD))
def test_hot_path_flags_host_copies_in_loops(tmp_path, name):
    _write(tmp_path, {"serving/gateway.py": _LOOP.format(expr=HOT_BAD[name])})
    out = _diags(tmp_path, "hot-path")
    assert [d.line for d in out] == [5], lint.render(out)
    assert out[0].path == "serving/gateway.py"


@pytest.mark.parametrize("fence", ["torch.cuda.synchronize()",
                                   "torch.cuda.current_stream().synchronize()",
                                   "ev.synchronize()"])
def test_hot_path_flags_fences_anywhere(tmp_path, fence):
    _write(tmp_path, {"serving/compiled.py": (
        "import torch\n"
        "def step(ev):\n"
        f"    {fence}\n")})
    out = _diags(tmp_path, "hot-path")
    assert [d.line for d in out] == [3] and "synchronize" in out[0].message


HOT_CLEAN = {
    # the step's one copy, outside any loop (LicensedGateway._sample)
    "boundary": (
        "def sample(logits, n):\n"
        "    toks = torch.argmax(logits[:n], -1).to(torch.int32)\n"
        "    host = logits[:n].to(device='cpu', dtype=torch.float32).numpy()\n"
        "    return toks.cpu().numpy(), host\n"),
    # the copy as a loop's header inside the step loop (ServingEngine)
    "loop_header": (
        "def generate(cur, group, steps):\n"
        "    for step in range(steps):\n"
        "        for i, t in enumerate(cur.tolist()):\n"
        "            group[i].append(t)\n"
        "        while bool(cur.any().item()):\n"
        "            break\n"
        "        group.extend([t for t in cur.tolist()])\n"),
    # host->device staging and numpy casts are no sync
    "staging": (
        "def stage(rows, outs, dev):\n"
        "    for i, r in enumerate(rows):\n"
        "        x = torch.from_numpy(r).to(dev)\n"
        "        n = int(outs[i])\n"
        "        f = float(np.percentile(r, 50))\n"
        "    return x, n, f\n"),
    # a nested function's body is judged on its own
    "nested_fn": (
        "def build(xs):\n"
        "    for x in xs:\n"
        "        def later(t):\n"
        "            return t.item()\n"
        "    return later\n"),
}


@pytest.mark.parametrize("name", sorted(HOT_CLEAN))
def test_hot_path_passes_sanctioned_sites(tmp_path, name):
    _write(tmp_path, {"serving/engine.py": "import numpy as np\nimport torch\n" + HOT_CLEAN[name]})
    assert _diags(tmp_path, "hot-path") == []


def test_hot_path_scope_and_suppression(tmp_path):
    """Only the step-loop modules under serving/ are scoped; an allow
    comment suppresses one site."""
    body = _LOOP.format(expr="x.item()")
    _write(tmp_path, {"serving/updates.py": body, "launch/engine.py": body,
                      "serving/scheduler.py": body.replace(
                          "x.item()", "x.item()  # lint: allow-hot-path")})
    assert _diags(tmp_path, "hot-path") == []


# ------------------------------------------------------------- RULE-KERNEL
_REF = (
    "def addone(x):\n    return x + 1\n"
    "def scatter(buf, i, v, donate=False):\n    return buf\n")
_BINDINGS = (
    "#include <torch/extension.h>\n"
    "PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {\n"
    '  m.def("addone", &addone, "x + 1");\n'
    '  m.def("scatter", &scatter, "buf[i] = v");\n'
    "}\n")
_WRAPPER = (
    "from repro_torch.kernels import ref\n"
    "def addone(x):\n"
    "    if x.device.type == 'cpu':\n"
    "        return ref.addone(x)\n"
    "    from repro_torch.kernels.build import load_extension\n"
    "    try:\n"
    "        return load_extension().addone(x)\n"
    "    except RuntimeError as e:\n"
    "        raise RuntimeError(f'addone failed: {e}')\n"
    "def scatter_inplace(buf, i, v):\n"
    "    from repro_torch.kernels.build import load_extension\n"
    "    ext = load_extension()\n"
    "    ext.scatter(buf, i, v)\n"
    "    return buf\n"
    "def plan(n):\n"
    "    return n // 2\n")


def _kernels(root, **over):
    files = {"kernels/ref.py": _REF, "kernels/csrc/bindings.cpp": _BINDINGS,
             "kernels/addone.py": _WRAPPER,
             "kernels/ops.py": ("from repro_torch.kernels.build import load_extension\n"
                                "def raw(x):\n    return load_extension().addone(x)\n"),
             "kernels/build.py": "def load_extension():\n    return None\n"}
    files.update(over)
    return _write(root, files)


def test_kernel_clean_when_paired_bound_and_raising(tmp_path):
    _kernels(tmp_path)
    assert _diags(tmp_path, "kernel") == []


def test_kernel_flags_wrapper_without_plain_version(tmp_path):
    _kernels(tmp_path, **{"kernels/mystery.py": (
        "def mystery(x):\n"
        "    from repro_torch.kernels.build import load_extension\n"
        "    return load_extension().addone(x)\n")})
    out = _diags(tmp_path, "kernel")
    assert [(d.path, d.line) for d in out] == [("kernels/mystery.py", 1)]
    assert "mystery" in out[0].message and "ref.py" in out[0].message


def test_kernel_flags_unbound_and_dead_kernels(tmp_path):
    _kernels(tmp_path, **{
        "kernels/csrc/bindings.cpp": _BINDINGS.replace(
            "}\n", '  m.def("orphan", &orphan, "never called");\n}\n'),
        "kernels/ghost.py": (
            "def addone_ghost(x):\n"
            "    from repro_torch.kernels.build import load_extension\n"
            "    ext = load_extension()\n"
            "    return ext.ghost(x)\n")})
    out = _diags(tmp_path, "kernel")
    assert [(d.path, d.line) for d in out] == [("kernels/csrc/bindings.cpp", 5),
                                               ("kernels/ghost.py", 4)]
    assert "orphan" in out[0].message and "dead" in out[0].message
    assert "ghost" in out[1].message and "m.def" in out[1].message


def test_kernel_dead_binding_suppressed_in_cpp(tmp_path):
    _kernels(tmp_path, **{"kernels/csrc/bindings.cpp": _BINDINGS.replace(
        "}\n", '  // lint: allow-kernel\n  m.def("orphan", &orphan, "kept");\n}\n')})
    assert _diags(tmp_path, "kernel") == []


@pytest.mark.parametrize("fallback", ["return ref.addone(x)", "return addone(x.cpu()).cuda()",
                                      "return addone(x.to('cpu'))"])
def test_kernel_flags_fallback_that_hides_the_kernel(tmp_path, fallback):
    _kernels(tmp_path, **{"kernels/addone.py": _WRAPPER.replace(
        "raise RuntimeError(f'addone failed: {e}')", fallback)})
    out = _diags(tmp_path, "kernel")
    assert [(d.path, d.line) for d in out] == [("kernels/addone.py", 8)]
    assert "falls back" in out[0].message


# ------------------------------------------------------------ the real tree
def test_port_tree_is_clean_without_serving_suppressions():
    diags = lint.run_paths([PORT])
    assert diags == [], lint.render(diags)
    for p in (PORT / "serving").rglob("*.py"):
        assert "lint: allow-" not in p.read_text(), f"suppression in serving/: {p}"


def test_port_rules_see_the_port():
    """The torch rules read what they check: every binding of the port's
    csrc/bindings.cpp is reached, and the scoped serving modules exist."""
    from repro_torch.analysis.rules import kernel

    kdir = PORT / "kernels"
    bound = kernel._bindings(kdir)
    assert len(bound) >= 9
    reached = set()
    for f in kdir.glob("*.py"):
        reached.update(a for a, _ in kernel._reached(kernel._parse(f)))
    assert set(bound) <= reached
    for name in ("scheduler.py", "paging.py", "gateway.py", "fleet.py", "engine.py",
                 "compiled.py"):
        assert (PORT / "serving" / name).is_file()


def test_jax_lint_over_src_stays_clean():
    diags = jax_lint.run_paths([REPO / "src"])
    assert diags == [], jax_lint.render(diags)


def test_cli_exit_codes_and_default_path(tmp_path, capsys):
    _write(tmp_path, {"serving/gateway.py": _LOOP.format(expr="x.item()"),
                      "serving/clean.py": "x = 1\n"})
    assert lint.main([str(tmp_path / "serving" / "clean.py")]) == 0
    assert lint.main([str(tmp_path / "serving" / "gateway.py")]) == 1
    assert "RULE-HOT-PATH" in capsys.readouterr().out
    assert lint.main([str(tmp_path), "--rule", "clock"]) == 0
    assert lint.main([]) == 0                       # src/repro_torch
    assert lint.DEFAULT_PATH == PORT
    with pytest.raises(SystemExit) as exc:
        lint.main([str(tmp_path), "--rule", "no-such-rule"])
    assert exc.value.code == 2


def test_module_entrypoint_and_no_jax():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--help"],
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0 and "repro_torch" in out.stdout
    probe = ("import sys\n"
             "from repro_torch.analysis import lint\n"
             "assert lint.main([]) == 0\n"
             "print(sorted(m for m in ('jax', 'torch', 'repro') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
