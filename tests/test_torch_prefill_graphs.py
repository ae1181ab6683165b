"""The compiled chunked-prefill step (``compiled.PrefillGraphs``) on the CPU.

On the card every prefill chunk of the default gateway is a CUDA graph,
one per (pow2 lane count, pow2 table width) and view, or per version on
the in-scan int8 path, the key of the JAX gateway's jitted chunk.  Here
the gateway takes the recording backend of ``test_torch_compiled``:
its capture runs the chunk again and keeps the function, its replay
runs that function on the same static buffers.  A capture's warm-up is
its chunk, so a chunk is either a capture or a replay.

Over the two-tier shared-prefix stream with preemptions and prefix
copy-on-writes, greedy tokens, the schedule and the stats through the
prefill (and decode) graphs must equal the eager gateway's, for float
views and the in-scan int8 dequant (``test_torch_compiled`` holds the
same gateway against the JAX gateway's on this stream); then the keys,
their drops with the views, the launch counts, sampled lanes and a
capture that raises, one by one.  One ``gpu`` test serves the stream
through real CUDA graphs against eager prefill.
"""
import weakref

import numpy as np
import pytest
import torch
from test_torch_compiled import (FREE, GEOMETRY, MODES, FailingCapture, Recorder,
                                 _check_counters, _drain, _scaled, _stream, _to)
from test_torch_compiled import cuda, weights  # noqa: F401  (the fixtures)

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.serving.paging import PagedCachePool as JaxPool

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.kernels import ops, ref
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import gateway as gateway_mod
from repro_torch.serving.compiled import DecodeGraphs, PrefillGraphs
from repro_torch.serving.paging import PagedCachePool
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _gateway(cfg, params, mode, backend=None, decode_graphs=True, **kw):
    """A CPU gateway whose prefill chunks go through ``backend`` (and,
    as on the card, its decode steps through the same backend)."""
    gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                         device="cpu", **{**GEOMETRY, **MODES[mode], **kw})
    if backend is not None:
        if decode_graphs:
            gw._graphs = DecodeGraphs(gw.slot, backend=backend)
        gw._prefill_graphs = PrefillGraphs(gw.slot, backend=backend)
    return gw


def _keys(gw):
    """Log the (tier, version, lanes, table width) of every chunk."""
    seen = []
    step = gw._prefill_graphs.step

    def logged(view, *args):
        tier, version = next(k for k, v in gw.views._entries.items() if v is view)
        seen.append((tier, version, *args[-2].shape))
        return step(view, *args)

    gw._prefill_graphs.step = logged
    return seen


STATS = ("preempted", "cow_copies", "prefix_tokens_reused", "decode_steps",
         "prefill_chunks", "prefill_lane_tokens", "prefill_batches", "max_blocks_in_use")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_graphs_match_eager(weights, mode):
    """Greedy tokens, the schedule and the stats through the prefill
    graphs equal the eager gateway's (and so the JAX gateway's, against
    which ``test_torch_compiled`` drains this stream through both graph
    sets).  One capture per distinct (tier, version, lanes, width) on
    float views, per (version, lanes, width) in-scan; every other chunk
    a replay."""
    _, _, cfg, params = weights
    stream = _stream()
    eager = _gateway(cfg, params, mode)
    ereqs = _drain(eager, stream)
    gw = _gateway(cfg, params, mode, backend=Recorder())
    seen = _keys(gw)
    _check_counters(gw)
    greqs = _drain(gw, stream)
    assert [r.out_tokens for r in greqs] == [r.out_tokens for r in ereqs]
    assert list(gw.trace) == list(eager.trace)
    for key in STATS:
        assert gw.stats[key] == eager.stats[key], key
    assert gw.stats["preempted"] > 0 and gw.stats["cow_copies"] > 0
    if mode == "float":
        want = set(seen)
    else:
        want = {k[1:] for k in seen}
        assert len(want) < len(set(seen))           # both tiers share a key
    assert len({k[2] for k in seen}) > 1 and len({k[3] for k in seen}) > 1
    graphs = gw._prefill_graphs
    assert graphs.keys() == want
    assert graphs.captures == len(want)
    assert graphs.replays + graphs.captures == len(seen) == gw.stats["prefill_chunks"]
    assert graphs.replays > 0
    # the decode graphs' keys and counts keep their own meaning
    assert all(len(k) == (3 if mode == "float" else 2) for k in gw._graphs.keys())
    assert gw._graphs.replays == gw.stats["resident_decode_steps"]
    assert gw._graphs.backend.captures == gw._graphs.captures + graphs.captures
    assert eager._prefill_graphs is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampled_lanes_draw_from_graph_rows(weights, mode):
    """Sampling stays outside the graph: a lane with a temperature draws
    its first token from the picked row exactly as the eager chunk's.
    Decode stays eager here, so only the prefill graphs differ."""
    _, _, cfg, params = weights
    stream = _stream(seed=1)
    runs = []
    for backend in (None, Recorder()):
        gw = _gateway(cfg, params, mode, backend=backend, decode_graphs=False)
        runs.append([r.out_tokens for r in
                     _drain(gw, stream, temperature=1.3, top_k=50, seed=7)])
        if backend is not None:
            assert gw._prefill_graphs.replays > 0
    assert runs[0] == runs[1]


def test_prefill_graphs_drop_with_their_views(weights):
    """A view evicted from a one-entry cache takes its prefill graphs
    along (captured again when its tier returns); a tier invalidation
    drops that tier's; the tokens stay the eager gateway's."""
    _, _, cfg, params = weights
    stream = _stream(seed=2)
    eager = _gateway(cfg, params, "float", view_capacity=1)
    ereqs = _drain(eager, stream)
    gw = _gateway(cfg, params, "float", backend=Recorder(), view_capacity=1)
    seen = _keys(gw)
    greqs = _drain(gw, stream)
    assert [r.out_tokens for r in greqs] == [r.out_tokens for r in ereqs]
    graphs = gw._prefill_graphs
    assert gw.views.evictions > 0
    assert graphs.captures > len(set(seen))        # recaptured after eviction
    assert {k[:2] for k in graphs.keys()} == {tuple(k) for k in gw.views._entries}
    (tier, version), view = next(iter(gw.views._entries.items()))
    held = weakref.ref(view.graphs)
    assert view.prefill_graphs is view.graphs.prefill
    del view
    gw.views.invalidate(tier=tier)
    assert len(graphs) == 0 and held() is None      # freed with the view


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_graphs_follow_version_gc(weights, mode):
    """A version's prefill graphs live while its views do and are freed
    when ``_gc_versions`` drops the version."""
    _, _, cfg, params = weights
    gw = _gateway(cfg, params, mode, backend=Recorder(), prefix_cache=False)
    stream = _stream(seed=3)
    old = [gw.submit(p, license=t, max_new_tokens=8) for t, p in stream[:2]]
    while not any(k[-3] == 1 for k in gw._prefill_graphs.keys()):
        gw.step()
    old_sets = [weakref.ref(v.graphs) for k, v in gw.views._entries.items() if k[1] == 1]
    assert gw.update_weights(_scaled(params)) == 2
    new = [gw.submit(p, license=t, max_new_tokens=3) for t, p in stream[2:4]]
    gw.run()
    assert all(r.version == 1 for r in old) and all(r.version == 2 for r in new)
    assert {k[-3] for k in gw._prefill_graphs.keys()} == {2}
    assert old_sets and all(r() is None for r in old_sets)


def test_prefill_replays_add_no_launch_counts(weights, monkeypatch):
    """In-scan, with the plain dequant counting as its kernel wrapper
    does: one count a quantized leaf and unit for every decode step and
    prefill chunk run eagerly; through the graphs, for every capture's
    warm-up only (decode's and prefill's), as on the card."""
    _, _, cfg, params = weights
    dequant = ref.masked_dequant

    def counted(*a, **kw):
        ops.LAUNCHES["masked_dequant"] += 1
        return dequant(*a, **kw)

    monkeypatch.setattr(ref, "masked_dequant", counted)
    stream = _stream(seed=4)
    per_run = cfg.pattern_units * 7      # wq wk wv wo w_gate w_up w_down
    for backend in (None, Recorder()):
        gw = _gateway(cfg, params, "in_scan", backend=backend)
        ops.reset_launches()
        _drain(gw, stream)
        if backend is None:
            runs = gw.stats["resident_decode_steps"] + gw.stats["prefill_chunks"]
        else:
            runs = gw._graphs.captures + gw._prefill_graphs.captures
        assert ops.LAUNCHES["masked_dequant"] == per_run * runs > 0
    graphs = gw._prefill_graphs
    assert graphs.replays == gw.stats["prefill_chunks"] - graphs.captures > 0


def test_failed_prefill_capture_raises_without_eager_retry(weights, monkeypatch):
    """The capture's error reaches the caller; the chunk is not retried
    eagerly, and the lane state its warm-up set is put back."""
    _, _, cfg, params = weights

    def no_eager(*a, **kw):
        raise AssertionError("the eager prefill step ran")

    monkeypatch.setattr(gateway_mod, "prefill_chunk_step", no_eager)
    gw = _gateway(cfg, params, "float", backend=FailingCapture())
    req = gw.submit(_stream()[0][1], max_new_tokens=4)
    state = {path: t.clone() for path, t in gw.pool.state.items()}
    with pytest.raises(RuntimeError, match="capture refused"):
        gw.step()
    assert all(torch.equal(gw.pool.state[path], t) for path, t in state.items())
    assert req.cursor == 0 and gw.stats["prefill_chunks"] == 0
    assert gw._prefill_graphs.captures == gw._prefill_graphs.replays == 0
    assert len(gw._prefill_graphs) == 0


@pytest.mark.parametrize("blocks", [8, 40])
def test_pool_nbytes_matches_jax(blocks):
    """``PagedCachePool.nbytes``: K and V blocks and the lane counters,
    the JAX pool's storage bytes."""
    kw = dict(num_lanes=3, capacity=20, block_size=4, num_blocks=blocks)
    pool = PagedCachePool(smoke_variant(get_config("qwen2.5-3b")), device="cpu", **kw)
    jpool = JaxPool(jax_smoke_variant(jax_get_config("qwen2.5-3b")), **kw)
    assert pool.nbytes == jpool.nbytes > blocks * pool.block_bytes


def test_pool_takes_device_tables_and_fills(weights):
    """The gather, the counters' pin and the scatter take the compiled
    step's static device inputs as they take host arrays."""
    _, _, cfg, _ = weights
    host, dev = (PagedCachePool(cfg, 3, 20, 4, 8, device="cpu") for _ in range(2))
    host.k.copy_(torch.randn(host.k.shape, generator=torch.Generator().manual_seed(0)))
    dev.k.copy_(host.k)
    tables = np.array([[2, 5, 8], [1, 8, 8]], np.int32)
    lanes, fills = np.array([0, 3], np.int64), np.array([9, 3], np.int32)
    for pool, wrap in ((host, np.asarray), (dev, torch.from_numpy)):
        caches = pool.gather(wrap(tables))
        caches["units"]["b0"]["k"].add_(1.0)
        caches = pool.override_counters(caches, wrap(fills))
        pool.scatter(wrap(lanes), wrap(tables), caches)
    assert torch.equal(host.k, dev.k) and torch.equal(host.v, dev.v)
    lens = host.state["units/b0/len"]
    assert torch.equal(lens, dev.state["units/b0/len"])
    assert lens[0].tolist() == [9] * cfg.pattern_units


# ------------------------------------------------------- on the card only
@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_graphs_match_eager_prefill_on_card(weights, cuda, mode):
    """The default gateway on the card (prefill and decode graphs)
    against the same gateway with its prefill graphs taken away: greedy
    tokens identical over the whole stream; every chunk a capture or a
    replay."""
    _, _, cfg, params = weights
    dev_params = _to(params, cuda)
    runs = []
    for graphs in (True, False):
        gw = LicensedGateway(cfg, dev_params, device=cuda,
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             **{**GEOMETRY, **MODES[mode]})
        assert gw._prefill_graphs is not None
        assert gw._prefill_graphs.backend is gw._graphs.backend
        if not graphs:
            gw._prefill_graphs = None
        runs.append((gw, [r.out_tokens for r in _drain(gw, _stream())]))
    (graph_gw, graph_toks), (_, eager_toks) = runs
    assert graph_toks == eager_toks
    pg = graph_gw._prefill_graphs
    assert pg.replays + pg.captures == graph_gw.stats["prefill_chunks"]
    assert pg.replays > 0 and all(r.state is RequestState.DONE for r in graph_gw.completed)
