"""The compiled steps of the gateway's other routes
(``repro_torch.serving.compiled``) on the CPU.

On the card every route's step is a CUDA graph: beside the
kernel-resident decode and the chunked prefill, the gather/scatter
decode on the paged and the contiguous pool (``GatherDecodeGraphs``,
one graph a view), the bucket prefill (``BucketPrefillGraphs``, one a
view), the prefix-hit suffix prefill (``SuffixPrefillGraphs``, one per
suffix width and view) and the plain kernel-resident decode
(``DecodeGraphs`` with ``decode_kernels=False``).  Here they take the
recording backend of ``tests/test_torch_compiled.py``, whose capture
runs the step once and whose replay runs it again on the same static
buffers (``ModelSlot.compile_steps``).

Each route runs a stream through an eager gateway and a compiled one in
lockstep, both recording their logits rows: the same action each step,
the logits rows and tokens bit for bit, and every pool leaf (K/V, rings,
counters, recurrent state) equal after every step, so a capture's
warm-up leaves nothing advanced.  A third, compiled gateway in the
default fused mode (greedy on the device) must give the JAX gateway's
tokens on the same route with the same weights (``params_from_jax``).
A capture that raises reaches the caller, and the eager step never
runs.  One ``gpu`` test serves the routes through real CUDA graphs.

Routes: smoke recurrentgemma-2b (its RG-LRU state and ring on the
paged pool: the gather/scatter decode and the bucket prefill),
mamba2-130m (the contiguous pool), qwen2.5-3b with
``kernel_decode=False``, with ``chunk_size=0`` and the prefix cache
(prefix hits through the suffix prefill; the plain kernel-resident
decode), and with ``paged=False``, and deepseek-v2-lite-16b under a
window, below the capacity (its latent ring on the contiguous pool) and
past it (the paged pool, the gather/scatter decode); each with float
views and the in-scan int8 dequant.
"""
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
from repro_torch.kernels import ops
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import gateway as gateway_mod
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_compiled import FailingCapture, Recorder

FREE = {"*": ((0.0, 0.01),)}
MODES = {"float": {}, "in_scan": dict(quantized=True)}
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=12)
# deepseek-v2-lite-16b's latent ring: a window of 8 below the capacity
# of 14, so the ring wraps (the contiguous pool).  The JAX package's
# windowed decode masks a ring by slot index, which from the first wrap
# on is not the window (``models/layers.py mla_block``): that route is
# held to the eager port only, and the JAX gateway is compared where the
# window lies past the capacity (32 over 20: the paged pool, no wrap;
# the bucket prefill, as windowed MLA has no chunked prefill)
WINDOW = 8
WINDOW_GEOMETRY = dict(max_batch=2, max_lanes=2, max_prompt=8, max_new_cap=6)

# route -> (arch, config changes, gateway arguments, families compiled,
# compared with the JAX gateway)
ROUTES = {
    "recurrentgemma_paged": ("recurrentgemma-2b", {}, {},
                             ("_gather_graphs", "_bucket_graphs"), True),
    "mamba2_contiguous": ("mamba2-130m", {}, {}, ("_gather_graphs", "_bucket_graphs"), True),
    "qwen_kernel_decode_off": ("qwen2.5-3b", {}, dict(kernel_decode=False),
                               ("_gather_graphs", "_prefill_graphs"), True),
    "qwen_bucket_prefix": ("qwen2.5-3b", {}, dict(chunk_size=0),
                           ("_graphs", "_bucket_graphs", "_suffix_graphs"), True),
    "qwen_contiguous": ("qwen2.5-3b", {}, dict(paged=False),
                        ("_gather_graphs", "_bucket_graphs"), True),
    "deepseek_window_ring": ("deepseek-v2-lite-16b", dict(window=WINDOW), {},
                             ("_gather_graphs", "_bucket_graphs"), False),
    "deepseek_window_paged": ("deepseek-v2-lite-16b", dict(window=32),
                              dict(chunk_size=0, prefix_cache=False),
                              ("_gather_graphs", "_bucket_graphs"), True),
}
FAMILIES = ("_graphs", "_prefill_graphs", "_gather_graphs", "_bucket_graphs", "_suffix_graphs")


def _stream(route, seed=0, n=6):
    """(tier, prompt), alternating tiers: on the prefix route a shared
    head of 8 tokens with own suffixes of 1-3 and exact repeats (prefix
    hits of several suffix widths), else prompts of several lengths."""
    rng = np.random.default_rng(seed)
    top = _geometry(route)["max_prompt"]
    if route == "qwen_bucket_prefix":
        head = rng.integers(0, 500, 8, dtype=np.int32)
        out = [("free" if i % 2 else "full",
                np.concatenate([head, rng.integers(0, 500, 1 + i % 3, dtype=np.int32)]))
               for i in range(n)]
        return out + [out[1], out[2], out[1]]
    return [("free" if i % 2 else "full",
             rng.integers(0, 500, 1 + (3 * i + 2) % top, dtype=np.int32)) for i in range(n)]


_WEIGHTS = {}


def _geometry(route):
    return WINDOW_GEOMETRY if route == "deepseek_window_ring" else GEOMETRY


def _weights(arch, changes):
    key = (arch, tuple(sorted(changes.items())))
    if key not in _WEIGHTS:
        jcfg = jax_smoke_variant(jax_get_config(arch)).replace(**changes)
        cfg = smoke_variant(get_config(arch)).replace(**changes)
        if cfg.num_experts:        # drop-free routing: the ring's tokens all reach the experts
            factor = cfg.num_experts / cfg.experts_per_token
            jcfg = jcfg.replace(moe_capacity_factor=factor)
            cfg = cfg.replace(moe_capacity_factor=factor)
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS[key] = (jcfg, jparams, cfg,
                         params_from_jax(jax_flatten_params(jparams), device="cpu"))
    return _WEIGHTS[key]


def _gateway(route, mode, backend=None, **kw):
    arch, changes, args = ROUTES[route][:3]
    _, _, cfg, params = _weights(arch, changes)
    gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                         device="cpu", **{**_geometry(route), **MODES[mode], **args, **kw})
    if backend is not None:
        gw.slot.compile_steps(backend)
    return gw


def _submit(gw, stream):
    return [gw.submit(p, license=t, max_new_tokens=6 - i % 2) for i, (t, p) in enumerate(stream)]


def _leaves(gw):
    pool = gw.pool
    return {**pool.leaves, **getattr(pool, "state", {})}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_graphs_match_eager_and_jax(route, mode):
    """Eager and compiled in lockstep (the same action, logits rows,
    tokens and pool after every step), then the compiled gateway's fused
    tokens against the JAX gateway's on the same route (the eager
    port's on the wrapping ring)."""
    arch, changes, args, families, with_jax = ROUTES[route]
    stream = _stream(route)
    eager = _gateway(route, mode, record_logits=True)
    gw = _gateway(route, mode, backend=Recorder(), record_logits=True)
    assert {f for f in FAMILIES if getattr(gw, f) is not None} == set(families)
    assert all(getattr(eager, f) is None for f in FAMILIES)
    reqs = [_submit(g, stream) for g in (eager, gw)]
    while True:
        acts = [g.step() for g in (eager, gw)]
        if acts[0] is None:
            assert acts[1] is None
            break
        assert (acts[0].kind, len(acts[0].requests)) == (acts[1].kind, len(acts[1].requests))
        want = _leaves(eager)
        for path, t in _leaves(gw).items():
            assert torch.equal(t, want[path]), path
    for e, g in zip(*reqs):
        assert g.state is RequestState.DONE and g.out_tokens == e.out_tokens
        assert len(g.logits_rows) == len(e.logits_rows)
        for a, b in zip(g.logits_rows, e.logits_rows):
            np.testing.assert_array_equal(a, b)
    assert list(gw.trace) == list(eager.trace)
    assert gw.stats == eager.stats
    for f in families:
        graphs = getattr(gw, f)
        assert graphs.captures > 0, f
        assert len(graphs) > 0 and graphs.captures >= len(graphs), f
        if f in ("_graphs", "_gather_graphs"):        # replayed at every decode step
            assert graphs.replays > graphs.captures, f
    if route == "qwen_bucket_prefix":
        assert gw.stats["prefix_tokens_reused"] > 0
        assert len({k[-1] for k in gw._suffix_graphs.keys()}) > 1     # several widths
    if route == "deepseek_window_ring":
        assert not gw.paged and max(r.pos for r in reqs[1]) > WINDOW    # the ring wrapped
    if mode == "in_scan":                              # one set for the version
        assert len({id(v.graphs) for v in gw.views._entries.values()}) == 1

    # the card's default mode: greedy on the device, against the JAX gateway
    fused = _gateway(route, mode, backend=Recorder())
    got = _submit(fused, stream)
    fused.run()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in reqs[0]]
    assert list(fused.trace) == list(eager.trace)
    if with_jax:
        jcfg, jparams, _, _ = _weights(arch, changes)
        jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                         telemetry=False, **_geometry(route), **MODES[mode], **args)
        jreqs = _submit(jgw, stream)
        jgw.run()
        assert [r.out_tokens for r in got] == [r.out_tokens for r in jreqs]
        assert list(fused.trace) == list(jgw.trace)


@pytest.mark.parametrize("family", ["_gather_graphs", "_bucket_graphs", "_suffix_graphs",
                                    "_graphs"])
def test_failed_capture_raises_without_eager_retry(family, monkeypatch):
    """A capture's error reaches the caller; the eager step is not run,
    no graph is kept, and the warm-up's lane state is put back."""
    route = {"_gather_graphs": "qwen_contiguous", "_bucket_graphs": "mamba2_contiguous",
             "_suffix_graphs": "qwen_bucket_prefix", "_graphs": "qwen_bucket_prefix"}[family]
    gw = _gateway(route, "float", backend=Recorder())
    graphs = getattr(gw, family)
    graphs.backend = FailingCapture()

    def no_eager(*a, **kw):
        raise AssertionError("the eager step ran")

    for name in ("prefill_step", "prefill_suffix_step", "serve_step", "serve_step_paged"):
        monkeypatch.setattr(gateway_mod, name, no_eager)
    stream = _stream(route)
    if family == "_suffix_graphs":                   # a first wave leaves prefixes behind
        graphs.backend = Recorder()
        _submit(gw, stream[:2])
        gw.run()
        graphs.backend = FailingCapture()
    _submit(gw, stream[6:7] if family == "_suffix_graphs" else stream[:1])
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="capture refused"):
        for _ in range(20):
            before = {p: t.clone() for p, t in _leaves(gw).items()}
            gw.step()
    if family in ("_graphs", "_gather_graphs"):      # a decode: nothing advanced
        after = _leaves(gw)
        assert all(torch.equal(after[p], t) for p, t in before.items()
                   if p in getattr(gw.pool, "state", {}))
    assert len(graphs) == 0 and graphs.replays == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_families_keep_their_own_keys(mode):
    """Each family reads only its own graphs from the views: the bucket
    prefill one a view, the suffix prefill one per (view, width), the
    kernel-resident decode's (view, table width) keys as before; in-scan
    the version stands for the view."""
    gw = _gateway("qwen_bucket_prefix", mode, backend=Recorder())
    _submit(gw, _stream("qwen_bucket_prefix"))
    gw.run()
    views = {tuple(k) if mode == "float" else (k[1],) for k in gw.views._entries}
    assert gw._bucket_graphs.keys() == views
    assert {k[:-1] for k in gw._suffix_graphs.keys()} <= views
    assert all(0 < k[-1] < GEOMETRY["max_prompt"] for k in gw._suffix_graphs.keys())
    bpl = gw.pool.blocks_per_lane
    assert {k[:-1] for k in gw._graphs.keys()} <= views
    assert all(k[-1] == bpl or k[-1] & (k[-1] - 1) == 0 for k in gw._graphs.keys())
    stored = sum(len(v.bucket_graphs) for v in {id(v.graphs): v for v in
                                                 gw.views._entries.values()}.values())
    assert stored == len(gw._bucket_graphs) + len(gw._suffix_graphs)
    for f in ("_graphs", "_bucket_graphs", "_suffix_graphs"):
        graphs = getattr(gw, f)
        assert graphs.captures == len(graphs) > 0, f
