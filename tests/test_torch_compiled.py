"""The compiled decode step (``repro_torch.serving.compiled``) on the CPU.

On the card ``DecodeGraphs`` captures the gateway's decode step as CUDA
graphs.  Here it takes a recording backend instead: its capture runs the
step once and keeps the function, and its replay runs that function
again on the same static buffers, which writes the static outputs.  A
real capture launches nothing and a real replay runs no Python, so the
recorder takes back whatever the kernel wrappers counted in either.  The
decode step itself is the CPU's plain path (``decode_kernels=False``),
whose ``ref.paged_decode_write`` a test wraps to count into
``ops.LAUNCHES`` as a kernel wrapper does.

Over a two-tier shared-prefix stream with preemptions and prefix
copy-on-writes, greedy tokens, sampled tokens and the schedule through
the graphs must equal the eager gateway's and, for greedy tokens and
the schedule, the JAX gateway's (float views and the in-scan int8
dequant), with the prefill chunks eager and through their graphs too.  The graph keys, their drops (view eviction, tier
invalidation, version GC), the launch counts (warm-ups only, no replay
adds any), the kernel path's table widths and a capture that raises are
checked one by one.  One ``gpu`` test serves a stream through real CUDA
graphs against the eager steps, on the kernel path and on every other
route (``tests/test_torch_fallback_graphs.py`` holds those on the CPU).
"""
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
from repro.serving import LicensedGateway as JaxGateway

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.kernels import ops, ref
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import gateway as gateway_mod
from repro_torch.serving.compiled import DecodeGraphs, PrefillGraphs, table_width
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREE = {"*": ((0.0, 0.01),)}
# two lanes a micro-batch over three, 4-token blocks, a pool of 8 blocks:
# preemptions and evictions of retained prefix chains
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=8)
MODES = {"float": {}, "in_scan": dict(quantized=True)}


class Recorder:
    """Capture backend of the CPU tests (see the module docstring)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        self.captures += 1
        self._uncounted(fn)
        return fn

    def replay(self, fn):
        self.replays += 1
        self._uncounted(fn)

    @staticmethod
    def _uncounted(fn):
        counted = dict(ops.LAUNCHES)
        fn()
        ops.LAUNCHES.update(counted)


class FailingCapture(Recorder):
    def capture(self, fn):
        raise RuntimeError("capture refused")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _stream(seed=0, n=8, head=8):
    """(tier, prompt): a shared system prefix with own suffixes of 1-3
    tokens, alternating tiers, then exact repeats (a capped full match
    and a copy-on-write of the donated tail at its first decode)."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, 500, head, dtype=np.int32)
    out = [("free" if i % 2 else "full",
            np.concatenate([sys_prompt, rng.integers(0, 500, 1 + i % 3, dtype=np.int32)]))
           for i in range(n)]
    return out + [out[1], out[2], out[1]]


def _gateway(cfg, params, mode, backend=None, **kw):
    gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                         device="cpu", **{**GEOMETRY, **MODES[mode], **kw})
    if backend is not None:
        gw._graphs = DecodeGraphs(gw.slot, backend=backend)
    return gw


def _drain(gw, stream, waves=2, **submit_kw):
    """Submit ``stream`` in ``waves`` rounds, draining between them, so
    the second round adopts the first round's retained prefixes."""
    reqs, per = [], -(-len(stream) // waves)
    for w in range(waves):
        reqs += [gw.submit(p, license=t, max_new_tokens=6 - i % 2, **submit_kw)
                 for i, (t, p) in enumerate(stream[w * per:(w + 1) * per])]
        gw.run()
    assert all(r.state.value == RequestState.DONE.value for r in reqs), \
        [r.error for r in reqs]
    return reqs


def _check_counters(gw):
    """After every step, each decoding lane's counters equal its position:
    a capture's warm-up must not leave them advanced."""
    step = gw.step

    def checked(**kw):
        act = step(**kw)
        for r in gw.scheduler.running:
            if r.state is RequestState.RUNNING:
                lens = gw.pool.state["units/b0/len"]
                assert lens[r.lane].tolist() == [r.pos] * gw.cfg.pattern_units
        return act

    gw.step = checked


def _widths(gw):
    """Log the (tier, version, table width) of every compiled step."""
    seen = []
    step = gw._graphs.step

    def logged(view, toks, poss, lanes, tables):
        tier, version = next(k for k, v in gw.views._entries.items() if v is view)
        seen.append((tier, version, tables.shape[1]))
        return step(view, toks, poss, lanes, tables)

    gw._graphs.step = logged
    return seen


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graphs_match_eager_and_jax(weights, mode):
    """Greedy tokens and the schedule through the graphs equal the eager
    gateway's and the JAX gateway's; preemptions and CoW copies happen.
    Float views: one graph per distinct (tier, version, width).  In-scan
    int8: one per distinct (version, width), shared by both tiers."""
    jcfg, jparams, cfg, params = weights
    stream = _stream()
    eager = _gateway(cfg, params, mode)
    ereqs = _drain(eager, stream)
    gw = _gateway(cfg, params, mode, backend=Recorder())
    seen = _widths(gw)
    _check_counters(gw)
    greqs = _drain(gw, stream)
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     telemetry=False, **GEOMETRY, **MODES[mode])
    jreqs = _drain(jgw, stream)
    assert [r.out_tokens for r in greqs] == [r.out_tokens for r in ereqs] \
        == [r.out_tokens for r in jreqs]
    assert list(gw.trace) == list(eager.trace) == list(jgw.trace)
    for key in ("preempted", "cow_copies", "prefix_tokens_reused", "decode_steps"):
        assert gw.stats[key] == eager.stats[key] == jgw.stats[key], key
    assert gw.stats["preempted"] > 0 and gw.stats["cow_copies"] > 0
    if mode == "float":
        want = set(seen)
    else:
        want = {(v, w) for _, v, w in seen}
        assert len(want) < len(set(seen))           # both tiers share a width
        sets = {id(view.graphs) for view in gw.views._entries.values()}
        assert len(sets) == 1                       # one set for the version
    assert gw._graphs.keys() == want
    assert gw._graphs.captures == len(want) == gw._graphs.backend.captures
    assert gw._graphs.replays == len(seen) == gw.stats["resident_decode_steps"]
    assert eager._graphs is None
    # the card's default, the prefill chunks through graphs on the same
    # backend too (tests/test_torch_prefill_graphs.py checks their keys)
    both = _gateway(cfg, params, mode, backend=Recorder())
    both._prefill_graphs = PrefillGraphs(both.slot, backend=both._graphs.backend)
    assert [r.out_tokens for r in _drain(both, stream)] == [r.out_tokens for r in jreqs]
    assert list(both.trace) == list(jgw.trace)
    for key in ("preempted", "cow_copies", "prefix_tokens_reused", "decode_steps",
                "prefill_chunks", "prefill_lane_tokens"):
        assert both.stats[key] == jgw.stats[key], key
    assert both._prefill_graphs.replays > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graphs_put_back_recurrent_lane_state(mode):
    """A window-0 hybrid of RG-LRU and attention blocks (recurrentgemma-2b's
    smoke variant, 5 layers with its tail, the window taken off) pages
    its K/V and takes the kernel-resident decode with the RG-LRU and conv
    state as lane state.  A capture's warm-up runs the step, so it must
    put back every lane-state leaf it advanced, not only the counters, or
    the replay after it advances the recurrent state a second time.  The
    graph gateway and the eager one step in lockstep: same steps, tokens
    and lane state after every step."""
    name = "recurrentgemma-2b"
    jcfg = jax_smoke_variant(jax_get_config(name)).replace(num_layers=5, window=0)
    cfg = smoke_variant(get_config(name)).replace(num_layers=5, window=0)
    params = params_from_jax(
        jax_flatten_params(jax_init_params(jax.random.PRNGKey(0), jcfg)), device="cpu")
    eager, gw = (_gateway(cfg, params, mode, backend=b) for b in (None, Recorder()))
    assert any(p.startswith("tail/") and p.endswith("/state") for p in gw.pool.state)
    for g in (eager, gw):
        assert g.paged and g.kernel_decode and g.chunk_size == 0 and g.prefix is None
    reqs = [[g.submit(p, license=t, max_new_tokens=6) for t, p in _stream()[:4]]
            for g in (eager, gw)]
    while True:
        acts = [g.step() for g in (eager, gw)]
        if acts[0] is None:
            assert acts[1] is None
            break
        assert acts[0].kind == acts[1].kind
        for path, t in eager.pool.state.items():
            assert torch.equal(gw.pool.state[path], t), path
    assert [r.out_tokens for r in reqs[1]] == [r.out_tokens for r in reqs[0]]
    assert all(r.state is RequestState.DONE for r in reqs[1])
    assert gw._graphs.captures > 0
    assert gw._graphs.replays == gw.stats["resident_decode_steps"] > gw._graphs.captures


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampled_lanes_draw_from_graph_logits(weights, mode):
    """Sampling stays outside the graph: lanes with a temperature draw
    from the static logits rows exactly as the eager step's."""
    _, _, cfg, params = weights
    stream = _stream(seed=1)
    runs = []
    for backend in (None, Recorder()):
        gw = _gateway(cfg, params, mode, backend=backend)
        runs.append([r.out_tokens for r in
                     _drain(gw, stream, temperature=1.3, top_k=50, seed=7)])
    assert runs[0] == runs[1]


def test_graphs_drop_with_their_views(weights):
    """A view evicted from a one-entry cache takes its graphs along (and
    is captured again when its tier returns); a tier invalidation drops
    that tier's graphs; the tokens stay the eager gateway's."""
    _, _, cfg, params = weights
    stream = _stream(seed=2)
    eager = _gateway(cfg, params, "float", view_capacity=1)
    ereqs = _drain(eager, stream)
    gw = _gateway(cfg, params, "float", backend=Recorder(), view_capacity=1)
    seen = _widths(gw)
    greqs = _drain(gw, stream)
    assert [r.out_tokens for r in greqs] == [r.out_tokens for r in ereqs]
    assert gw.views.evictions > 0
    assert gw._graphs.captures > len(set(seen))    # recaptured after eviction
    assert {k[:2] for k in gw._graphs.keys()} == {tuple(k) for k in gw.views._entries}
    (tier, version), view = next(iter(gw.views._entries.items()))
    graphs = weakref.ref(view.graphs)
    del view
    gw.views.invalidate(tier=tier)
    assert len(gw._graphs) == 0 and graphs() is None      # freed with the view


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graphs_follow_version_gc(weights, mode):
    """A version's graphs live while requests pinned to it decode, and
    are freed when ``_gc_versions`` drops the version."""
    _, _, cfg, params = weights
    gw = _gateway(cfg, params, mode, backend=Recorder(), prefix_cache=False)
    stream = _stream(seed=3)
    old = [gw.submit(p, license=t, max_new_tokens=8) for t, p in stream[:2]]
    while not any(k[-2] == 1 for k in gw._graphs.keys()):
        gw.step()
    old_sets = [weakref.ref(v.graphs) for k, v in gw.views._entries.items() if k[1] == 1]
    assert gw.update_weights(_scaled(params)) == 2
    new = [gw.submit(p, license=t, max_new_tokens=3) for t, p in stream[2:4]]
    while any(r.state is not RequestState.DONE for r in old):
        gw.step()
        if any(r.state is not RequestState.DONE for r in old):
            assert any(k[-2] == 1 for k in gw._graphs.keys())   # v1 pinned
    gw.run()
    assert all(r.version == 1 for r in old) and all(r.version == 2 for r in new)
    versions = {k[-2] for k in gw._graphs.keys()}
    assert versions == {2}
    assert old_sets and all(r() is None for r in old_sets)


def test_replays_add_no_launch_counts(weights, monkeypatch):
    """With the plain write counting as a kernel wrapper does, the
    counts through the graphs are one a layer per capture's warm-up,
    which really ran the step; the capture launched nothing and a
    replay runs no wrapper.  The eager gateway counts one a layer per
    step."""
    _, _, cfg, params = weights
    write = ref.paged_decode_write

    def counted(*a, **kw):
        ops.LAUNCHES["paged_decode_write"] += 1
        return write(*a, **kw)

    monkeypatch.setattr(ref, "paged_decode_write", counted)
    stream = _stream(seed=4)
    units = cfg.pattern_units
    for backend in (None, Recorder()):
        gw = _gateway(cfg, params, "float", backend=backend)
        ops.reset_launches()
        _drain(gw, stream)
        steps = gw.stats["resident_decode_steps"]
        want = units * (steps if backend is None else gw._graphs.captures)
        assert ops.LAUNCHES["paged_decode_write"] == want > 0
    assert gw._graphs.replays == steps > gw._graphs.captures > 0


def test_failed_capture_raises_without_eager_retry(weights, monkeypatch):
    _, _, cfg, params = weights

    def no_eager(*a, **kw):
        raise AssertionError("the eager decode step ran")

    monkeypatch.setattr(gateway_mod, "serve_step_paged", no_eager)
    """The capture's error reaches the caller; the step is not retried
    eagerly, and the lane state the warm-up advanced is put back."""
    gw = _gateway(cfg, params, "float", backend=FailingCapture())
    req = gw.submit(_stream()[0][1], max_new_tokens=4)
    while req.state is not RequestState.RUNNING:
        assert gw.step().kind == "prefill"
    state = {path: t.clone() for path, t in gw.pool.state.items()}
    with pytest.raises(RuntimeError, match="capture refused"):
        gw.step()
    assert all(torch.equal(gw.pool.state[path], t) for path, t in state.items())
    assert gw.stats["decode_steps"] == 0 and gw._graphs.replays == 0
    assert len(gw._graphs) == 0


@pytest.mark.parametrize("cap", [1, 6, 256])
def test_table_width_buckets(cap):
    """The kernel path's table widths: the next power of two at or above
    the used width, capped at ``blocks_per_lane``: ceil(log2(cap)) + 1
    distinct widths, so as many graphs a view at most."""
    widths = [table_width(n, cap) for n in range(1, cap + 1)]
    assert all(n <= w <= cap for n, w in zip(range(1, cap + 1), widths))
    assert all(w == cap or w & (w - 1) == 0 for w in widths)
    assert all(w < 2 * n for n, w in zip(range(1, cap + 1), widths))
    assert widths == sorted(widths) and len(set(widths)) == (cap - 1).bit_length() + 1


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the decode kernels run "
                    "only on the card")
    return torch.device("cuda")


def _scaled(tree):
    return {k: (v * 1.01 if isinstance(v, torch.Tensor) else _scaled(v))
            for k, v in tree.items()}


def _to(tree, device):
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else _to(v, device))
            for k, v in tree.items()}


# the card's routes: the kernel path (the default), the plain
# kernel-resident decode, and the bucket path's families
CARD_ROUTES = {"kernels": {}, "plain_decode": dict(decode_kernels=False),
               "kernel_decode_off": dict(kernel_decode=False),
               "bucket_prefix": dict(chunk_size=0), "contiguous": dict(paged=False)}
FAMILIES = ("_graphs", "_prefill_graphs", "_gather_graphs", "_bucket_graphs", "_suffix_graphs")


# the JAX gateway's names for the card routes' arguments
JAX_ROUTE_ARGS = {"decode_kernels": lambda v: ("decode_pallas", "pallas" if v else "off")}


@pytest.mark.parametrize("route", sorted(CARD_ROUTES))
def test_card_routes_decide_kernel_decode_as_jax(weights, route):
    """The rule behind the card test's launch counts is the JAX
    package's: on each card route the port's gateway takes the
    kernel-resident decode, and the paged pool, exactly where the JAX
    gateway on the same smoke config does."""
    jcfg, jparams, cfg, params = weights
    kw = CARD_ROUTES[route]
    jkw = dict(JAX_ROUTE_ARGS[k](v) if k in JAX_ROUTE_ARGS else (k, v) for k, v in kw.items())
    tiers = {"free": LicenseTier(name="free", masks=FREE)}
    jtiers = {"free": JaxLicenseTier(name="free", masks=FREE)}
    gw = LicensedGateway(cfg, params, tiers=tiers, device="cpu", **{**GEOMETRY, **kw})
    jgw = JaxGateway(jcfg, jparams, tiers=jtiers, **{**GEOMETRY, **jkw})
    assert (gw.metrics()["decode_path"]["kernel_resident"]
            == jgw.metrics()["decode_path"]["kernel_resident"])
    assert gw.paged == jgw.paged


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(CARD_ROUTES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_graphs_match_eager_kernels_on_card(weights, cuda, mode, route):
    """The default gateway on the card (CUDA graphs on every route)
    against the same gateway with the graphs taken away (the eager
    steps): greedy tokens identical over the whole stream, every family
    of the route captured and replayed; on the kernel path the wrappers
    count the warm-ups' launches only."""
    _, _, cfg, params = weights
    dev_params = _to(params, cuda)
    runs = []
    for graphs in (True, False):
        gw = LicensedGateway(cfg, dev_params, device=cuda,
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             **{**GEOMETRY, **MODES[mode], **CARD_ROUTES[route]})
        families = [f for f in FAMILIES if getattr(gw, f) is not None]
        assert families
        if not graphs:
            gw.slot.compile_steps(None)
        ops.reset_launches()
        toks = [r.out_tokens for r in _drain(gw, _stream())]
        runs.append((gw, toks, ops.LAUNCHES["paged_attention"]))
    (graph_gw, graph_toks, graph_n), (eager_gw, eager_toks, eager_n) = runs
    assert graph_toks == eager_toks
    for f in families:
        assert getattr(graph_gw, f).captures > 0, f
    decode = graph_gw._graphs if graph_gw.kernel_decode else graph_gw._gather_graphs
    assert decode.replays == graph_gw.stats["decode_steps"] > decode.captures
    # the counts follow the gateway's own decode path, not the route's
    # name: the bucket route keeps the kernel-resident decode (both
    # packages decide it by the pool and the window alone)
    if graph_gw.kernel_decode and graph_gw.decode_kernels:
        # the wrappers count the warm-ups' launches, never a capture's
        units = cfg.pattern_units
        assert graph_n == units * graph_gw._graphs.captures
        assert eager_n == units * eager_gw.stats["resident_decode_steps"]
    else:
        assert graph_n == eager_n == 0
    if route != "kernels":
        return
    graphs = graph_gw._graphs
    assert graph_gw.decode_kernels and graph_gw.metrics()["decode_path"]["pallas"] == "pallas"
    bpl = graph_gw.pool.blocks_per_lane
    assert {k[-1] for k in graphs.keys()} <= {table_width(n, bpl) for n in range(1, bpl + 1)}
