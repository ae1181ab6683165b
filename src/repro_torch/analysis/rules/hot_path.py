"""RULE-HOT-PATH: no host<->device sync inside the port's step loops.

The serving loop's latency contract is one bounded host transfer per
scheduler step, at the step boundary: ``LicensedGateway._sample`` copies
the step's token ids (or, in host mode, the step's rows) once, and
``ServingEngine`` copies each step's ids as the iterable of the loop
that hands them out.  A loop body that brings a CUDA tensor to the host
(``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
or ``int()`` / ``float()`` / ``bool()`` / ``np.asarray()`` of one)
waits for the card once per iteration instead of once per step, and
``torch.cuda.synchronize()`` stalls the launch queue wherever it stands.

Checks, over ``serving/`` ``scheduler.py``, ``paging.py``,
``gateway.py``, ``fleet.py``, ``engine.py`` and ``compiled.py``:

* anywhere in the module: ``torch.cuda.synchronize()`` and any
  ``.synchronize()`` call (a stream's or an event's, e.g.
  ``torch.cuda.current_stream().synchronize()``) — the counterpart of
  the JAX rule's ``.block_until_ready``; only benchmarks and
  ``chip_smoke.py`` fence;
* inside ``for`` / ``while`` bodies and comprehension elements only.  A
  loop's header (its ``iter`` and ``test``, as in the JAX rule, and a
  comprehension's iterables) is the sanctioned place for the step's one
  copy, and passes wherever the loop stands; a copy in a loop's body
  runs once per iteration and is flagged:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to(...)``
  with ``"cpu"`` as its device, and ``float()`` / ``int()`` / ``bool()``
  / ``np.asarray()`` / ``np.array()`` whose argument mentions ``torch``
  or calls a tensor-only method (``.item()``, ``.float()``, ``.to()``,
  ...).  A cast around a call already flagged is not reported again.
  Host->device staging (``torch.from_numpy(a).to(device)``) is not a
  sync and stays legal.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.lint import Diagnostic, ModuleInfo, ancestors
from repro_torch.analysis.rules import Rule, _attr_chain

_SCOPED_FILES = {"scheduler.py", "paging.py", "gateway.py", "fleet.py",
                 "engine.py", "compiled.py"}
_CASTS = {"float", "int", "bool"}
_NP_MATERIALIZE = (["np", "asarray"], ["np", "array"],
                   ["numpy", "asarray"], ["numpy", "array"])
_HOST_COPIES = {"item", "tolist", "cpu", "numpy"}
# methods a numpy array does not have: a call of one marks a tensor
_TENSOR_METHODS = _HOST_COPIES | {"to", "cuda", "detach", "clone", "contiguous",
                                  "float", "double", "half", "bfloat16", "long",
                                  "int", "bool"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_cpu(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    # torch.device("cpu")
    return (isinstance(node, ast.Call) and _attr_chain(node.func)[-1:] == ["device"]
            and bool(node.args) and _is_cpu(node.args[0]))


def _host_copy(node: ast.Call) -> str:
    """The name of the host copy ``node`` makes, or ''."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return ""
    if fn.attr in _HOST_COPIES:
        return f".{fn.attr}()"
    if fn.attr == "to" and (
            (node.args and _is_cpu(node.args[0]))
            or any(k.arg == "device" and _is_cpu(k.value) for k in node.keywords)):
        return '.to("cpu")'
    return ""


def _mentions_tensor(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == "torch":
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _TENSOR_METHODS:
            return True
    return False


def _contains_host_copy(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _host_copy(n) for n in ast.walk(node))


def _in_loop(node: ast.AST) -> bool:
    """``node`` runs once per iteration of an enclosing loop of its own
    function: in a loop's body or ``else``, or in a comprehension's
    element or conditions.  A loop's header (its ``iter`` or ``test``, a
    comprehension's iterables) is the step boundary: what it copies feeds the whole loop, so a node there passes
    even when the loop itself stands in an outer step loop
    (``ServingEngine``'s ``for i, t in enumerate(cur.tolist())`` inside
    its loop over steps)."""
    child: ast.AST = node
    for parent in ancestors(node):
        if isinstance(parent, _LOOPS):
            if child is getattr(parent, "iter", None) or child is getattr(parent, "test", None):
                return False
            if child is not getattr(parent, "target", None):
                return True
        if isinstance(parent, ast.comprehension) and child is parent.iter:
            return False
        if isinstance(parent, _COMPREHENSIONS) and child is not parent.generators[0]:
            return True
        if isinstance(parent, _SCOPES):
            return False          # nested fn bodies judged on their own
        child = parent
    return False


class HotPathRule(Rule):
    name = "hot-path"

    def applies(self, module: ModuleInfo) -> bool:
        return "serving" in module.parts and module.name in _SCOPED_FILES

    def check(self, module: ModuleInfo) -> Iterable[Diagnostic]:
        if not self.applies(module):
            return []
        out: List[Diagnostic] = []

        def report(node, message):
            d = module.diag(node, self.name, message)
            if d:
                out.append(d)

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "synchronize":
                what = ".".join(chain) if chain else "<stream or event>.synchronize"
                report(node, f"`{what}()` in the serving path waits for the card; "
                             f"only benchmarks and chip_smoke may fence explicitly")
                continue
            if not _in_loop(node):
                continue
            copy = _host_copy(node)
            if copy:
                report(node, f"`{copy}` on a tensor inside a step loop copies to the "
                             f"host per iteration; hoist one copy to the step boundary")
                continue
            is_cast = isinstance(node.func, ast.Name) and node.func.id in _CASTS
            is_np = chain in _NP_MATERIALIZE
            if (is_cast or is_np) and node.args and _mentions_tensor(node.args[0]) \
                    and not _contains_host_copy(node.args[0]):
                what = node.func.id if is_cast else ".".join(chain)
                report(node, f"`{what}(...)` of a tensor inside a step loop syncs per "
                             f"iteration; hoist the transfer to the step boundary")
        return out
