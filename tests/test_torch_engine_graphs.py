"""The compiled ``ServingEngine`` (``repro_torch.serving.compiled.
EngineGraphs``) on the CPU.

On the card the engine's prefill and decode are CUDA graphs, one per
(view, lanes, prompt width, capacity) and (view, lanes, capacity), the
JAX engine's jit keys.  Here the engine takes a recording backend that
models CUDA's: its warm-up runs the step, its capture records the
function and runs nothing, and its replay runs the function again on
the same static buffers, taking back whatever the kernel wrappers
counted (a replay runs no Python on the card).  The in-scan int8
dequant's plain version is wrapped to count into ``ops.LAUNCHES`` as
its kernel wrapper does.

Over mixed-tier batches of smoke qwen2.5-3b (float views and the
in-scan int8 store) and mamba2-130m (recurrent lane state in the
engine's static cache), greedy tokens through the graphs must equal the
eager engine's and the JAX ``ServingEngine``'s; a second ``generate`` of
the same requests only replays; the keys, the in-scan tiers' one set,
the graphs' going with an evicted view, the launch counts (warm-ups
only) and a failing capture are checked one by one.  One ``gpu`` test
holds the card's graphs against the eager engine.
"""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.pytree_io import flatten_params
from repro_torch.kernels import ops, ref
from repro_torch.models.model import params_from_jax
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.compiled import EngineGraphs
from repro_torch.serving.quantized import qleaves
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREE = {"*": ((0.0, 0.004),)}
# (prompt seed, prompt length, new tokens, tier): two groups, the full
# tier's two prompts of different lengths (the shorter right-aligned)
SPECS = [(0, 12, 5, "full"), (1, 8, 4, "full"), (2, 8, 5, "free")]
MODELS = {"qwen_float": ("qwen2.5-3b", {}),
          "qwen_in_scan": ("qwen2.5-3b", dict(quantized=True)),
          "mamba2": ("mamba2-130m", {})}


class Recorder:
    """Capture backend of the CPU tests (see the module docstring)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        self.captures += 1
        return fn

    def replay(self, fn):
        self.replays += 1
        counted = dict(ops.LAUNCHES)
        fn()
        ops.LAUNCHES.update(counted)


class FailingCapture(Recorder):
    """Refuses the ``fail_at``-th capture (1-based)."""

    def __init__(self, fail_at=1):
        super().__init__()
        self.fail_at = fail_at

    def capture(self, fn):
        if self.captures + 1 == self.fail_at:
            raise RuntimeError("capture refused")
        return super().capture(fn)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name, kw = MODELS[request.param]
    jcfg = jax_smoke_variant(jax_get_config(name))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config(name))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    jeng = JaxEngine(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     **kw)
    jreqs = _requests(JaxRequest)
    jeng.generate(jreqs)
    return dict(cfg=cfg, params=params, kw=kw, jax_tokens=[r.out_tokens for r in jreqs],
                name=request.param)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)


def _requests(cls=Request):
    return [cls(prompt=_prompt(s, n), max_new_tokens=m, license=t) for s, n, m, t in SPECS]


def _engine(model, backend=None, **kw):
    eng = ServingEngine(model["cfg"], model["params"],
                        tiers={"free": LicenseTier(name="free", masks=FREE)},
                        device="cpu", **{**model["kw"], **kw})
    assert eng._graphs is None                  # the CPU's engine is eager
    if backend is not None:
        eng._graphs = EngineGraphs(eng, backend=backend)
    return eng


def _tokens(eng):
    reqs = _requests()
    eng.generate(reqs)
    return [r.out_tokens for r in reqs]


def _want_keys(quantized):
    """The jit keys of SPECS' groups: (tier,) "prefill", b, max_prompt,
    capacity and "decode", b, capacity."""
    keys = set()
    for tier in ("full", "free"):
        group = [(n, m) for _, n, m, t in SPECS if t == tier]
        b, mp = len(group), max(n for n, _ in group)
        cap = mp + max(m for _, m in group)
        pre = () if quantized else (tier,)
        keys |= {(*pre, "prefill", b, mp, cap), (*pre, "decode", b, cap)}
    return keys


def test_graph_tokens_match_eager_and_jax(model):
    """Greedy tokens through the graphs equal the eager engine's and the
    JAX engine's; a second ``generate`` of the same requests replays
    every step (prefills too) and captures nothing; the keys are the
    groups' distinct shapes per view."""
    eager = _tokens(_engine(model))
    assert eager == model["jax_tokens"]
    rec = Recorder()
    eng = _engine(model, rec)
    assert _tokens(eng) == eager
    g = eng._graphs
    decodes = sum(max(m for _, _, m, t in SPECS if t == tier) - 1 for tier in ("full", "free"))
    # each group: a prefill captured (its warm-up is the prefill) and a
    # decode captured, then replayed for every decode step
    assert (g.captures, g.replays) == (rec.captures, rec.replays) == (4, decodes)
    assert g.keys() == _want_keys(eng.quantized) and len(g) == 4
    assert _tokens(eng) == eager
    assert (g.captures, g.replays) == (4, 2 * decodes + 2)


def test_in_scan_tiers_share_one_set(model):
    """In-scan, every tier's view holds the store's one set, so a second
    tier with the first's shapes captures nothing new; float views each
    hold their own."""
    eng = _engine(model, Recorder())
    _tokens(eng)
    full, free = (eng._views.get(t) for t in ("full", "free"))
    assert (full.engine_graphs is free.engine_graphs) == eng.quantized
    if eng.quantized:
        assert full[0] is free[0] is eng.base_params
        reqs = [Request(prompt=_prompt(5, 8), max_new_tokens=5, license="free"),
                Request(prompt=_prompt(6, 12), max_new_tokens=3, license="free")]
        eng.generate(reqs)          # the full group's (2, 12, 17): replays only
        assert eng._graphs.captures == 4
        want = Request(prompt=_prompt(5, 8), max_new_tokens=5, license="free")
        other = Request(prompt=_prompt(6, 12), max_new_tokens=3, license="free")
        _engine(model).generate([want, other])
        assert [r.out_tokens for r in reqs] == [want.out_tokens, other.out_tokens]


def test_graphs_go_with_an_evicted_view(model):
    """A view evicted from the engine's cache takes its graphs along (the
    in-scan set lives while a tier's view holds it)."""
    eng = _engine(model, Recorder())
    eng._views.capacity = 1
    eng.generate([Request(prompt=_prompt(0, 8), max_new_tokens=3, license="full")])
    graph = next(iter(eng._views.get("full").engine_graphs.values()))
    alive = weakref.ref(graph)
    del graph
    eng.generate([Request(prompt=_prompt(1, 8), max_new_tokens=3, license="free")])
    assert ("full", None) not in eng._views and eng._views.evictions == 1
    pre = () if eng.quantized else ("free",)
    assert eng._graphs.keys() == {(*pre, "prefill", 1, 8, 11), (*pre, "decode", 1, 11)}
    gc.collect()
    # in-scan the free tier's view holds the same set, graph and all
    assert (alive() is not None) == eng.quantized


def test_masked_dequant_counted_at_warmups_only(model, monkeypatch):
    """The in-scan dequant's launches pass the wrapper in the captures'
    warm-ups only: one per int8 leaf of every unit a warm-up, never in a
    replay."""
    plain = ref.masked_dequant

    def counted(*a, **kw):
        ops.LAUNCHES["masked_dequant"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "masked_dequant", counted)
    ops.reset_launches()
    eng = _engine(model, Recorder())
    _tokens(eng)
    _tokens(eng)
    leaves = (sum(1 for _ in qleaves(eng.base_params["units"])) * model["cfg"].pattern_units
              if eng.quantized else 0)
    assert ops.LAUNCHES["masked_dequant"] == leaves * eng._graphs.captures
    assert eng._graphs.replays > eng._graphs.captures


@pytest.mark.parametrize("fail_at", [1, 2], ids=["prefill", "decode"])
def test_failing_capture_raises_and_leaves_no_state(model, fail_at):
    """A refused capture raises out of ``generate`` (no eager retry):
    no graph is kept, no capture counted, and the static cache holds no
    half-step (zeros after a refused prefill, the prefill's state after a
    refused decode); the engine then serves on a working backend."""
    eng = _engine(model, FailingCapture(fail_at))
    group = [Request(prompt=_prompt(0, 8), max_new_tokens=3, license="full")]
    state = {}
    prefill = eng._graphs.prefill

    def kept(*a, **kw):
        out = prefill(*a, **kw)
        state.update({k: t.clone() for k, t in flatten_params(eng._graphs.caches[(1, 11)]).items()})
        return out

    eng._graphs.prefill = kept
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate(group)
    assert eng._graphs.captures == fail_at - 1 and len(eng._graphs) == fail_at - 1
    cache = flatten_params(eng._graphs.caches[(1, 11)])
    if fail_at == 1:
        assert not any(t.any() for t in cache.values())
    else:
        assert all(torch.equal(cache[k], t) for k, t in state.items())
    eng._graphs = EngineGraphs(eng, backend=Recorder())
    want = [Request(prompt=_prompt(0, 8), max_new_tokens=3, license="full")]
    _engine(model).generate(want)
    again = [Request(prompt=_prompt(0, 8), max_new_tokens=3, license="full")]
    eng.generate(again)
    assert again[0].out_tokens == want[0].out_tokens


@pytest.mark.gpu
def test_cuda_graphs_match_eager_engine(model):
    """On the card: the default engine (CUDA graphs) against the same
    engine with its graphs taken away, greedy tokens identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = params_from_jax({k: v.numpy() for k, v in flatten_params(model["params"]).items()},
                             device="cuda")
    eng = ServingEngine(model["cfg"], params,
                        tiers={"free": LicenseTier(name="free", masks=FREE)},
                        device="cuda", **model["kw"])
    assert isinstance(eng._graphs, EngineGraphs)
    graphs = _tokens(eng)
    assert _tokens(eng) == graphs and eng._graphs.replays > 0
    eng._graphs = None
    assert _tokens(eng) == graphs
