"""Int8 KV caches (``kv_cache_int8=True``) in the port, against the JAX
package, on the CPU.

* ``layers._kv_quantize`` / ``_kv_dequantize``: codes and scales bit for
  bit (half-way values, zero rows, f32 and bf16 inputs);
* the model on the qwen2.5-3b smoke variant with int8 K/V: a contiguous
  prefill then decode steps, the chunked prefill with ragged lanes, the
  suffix prefill over a resident prefix, and the paged decode's plain
  route (the kernel route refuses an int8 cache);
* the ring (recurrentgemma-2b's attention block): chunks with per-lane
  ``chunk_valid`` whose pad rows keep the resident codes and scales,
  then decode over the wrapped ring;
* the pools: the scale leaves paged beside the codes, ``block_bytes``
  (musicgen-large's 69,632 B a layer-block against 131,072 in bf16);
* the gateway: greedy tokens per tier against the JAX gateway on float
  and int8 views, prefix-cache hits against the cold run, the graph
  route through the recording backend of ``test_torch_compiled.py`` (no
  paged kernel counted), and ``decode_kernels=True`` refused.

Weights are the JAX package's smoke weights carried across with
``params_from_jax``; inputs come from numpy seeds.  The two frameworks'
K/V differ in their last bits (``test_torch_model.py``'s 1e-4 covers
that in f32), and where a value lies that close to a rounding edge its
int8 code differs by one step: one such code moved a logit by 1.9e-4 at
these weights, so logits read from an int8 cache are held at atol = rtol
= 1e-3, codes to one step, scales to rtol 1e-5, lengths and tokens
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.engine import prefill_chunk_step as jax_prefill_chunk_step
from repro.serving.engine import prefill_suffix_step as jax_prefill_suffix_step
from repro.serving.engine import serve_step_paged as jax_serve_step_paged
from repro.serving.engine import stack_lane_caches as jax_stack_lane_caches
from repro.serving.paging import PagedCachePool as JaxPagedCachePool

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models import layers, model
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import engine
from repro_torch.serving.compiled import DecodeGraphs, PrefillGraphs
from repro_torch.serving.paging import PagedCachePool
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_compiled import Recorder, _stream

TOL = dict(atol=1e-3, rtol=1e-3)
FREE = {"*": ((0.0, 0.01),)}
QUANT = ("k", "v", "k_scale", "v_scale")
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b")).replace(kv_cache_int8=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b")).replace(kv_cache_int8=True)
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 500, shape, dtype=np.int32)


def _same_cache(got, want):
    """The two frameworks' K/V differ in the last bits (their products sum
    in other orders), so the scales agree to rtol 1e-5 and a code may
    move by one step where a value straddles a rounding edge; the lengths
    are exact.  (``test_kv_quantize_bit_equal`` holds the quantizers bit
    for bit on the same inputs.)"""
    for k in ("k", "v"):
        diff = got[k].int().numpy() - np.asarray(want[k]).astype(np.int32)
        assert np.abs(diff).max() <= 1, k
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(want["len"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_equal(dtype):
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 17, 2, 64))
         * np.exp(r.uniform(-6, 6, (3, 17, 2, 1)))).astype(np.float32)
    x[0, 0] = 0.0                                  # a zero row: scale 1, codes 0
    x[0, 1, 1] = np.arange(64) - 63.5              # amax 127 after x[..., 0] = 127:
    x[0, 1, 1, 0] = 127.0                          # scale 1, codes on .5 edges
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jc, js = jax_layers._kv_quantize(jx)
    tc, ts = layers._kv_quantize(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 17, 2, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[0, 0] == 1).all() and (tc[0, 0] == 0).all()
    if dtype == "float32":   # half to even: -62.5 -> -62, -61.5 -> -62, -60.5 -> -60
        assert tc[0, 1, 1, 1:4].tolist() == [-62, -62, -60]
    np.testing.assert_array_equal(
        layers._kv_dequantize(tc, ts, torch.float32).numpy(),
        np.asarray(jax_layers._kv_dequantize(jc, js, jnp.float32)))


def test_init_cache_leaves(qwen):
    jcfg, _, cfg, _ = qwen
    got = model.init_cache(cfg, 2, 10, device="cpu")["units"]["b0"]
    want = jax_model.init_cache(jcfg, 2, 10)["units"]["b0"]
    assert set(got) == set(want) == set(QUANT) | {"len"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_prefill_then_decode(qwen):
    """A contiguous prefill from empty (attends its fresh float K/V), then
    three decode steps reading the dequantized cache."""
    jcfg, jparams, cfg, params = qwen
    toks, cap = _tokens(1, (2, 6)), 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    got, cache = model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for step in range(3):
        nxt = _tokens(10 + step, (2, 1))
        want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache,
                                            pos=6 + step)
        got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache,
                                   pos=6 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for u in range(cfg.pattern_units):
        _same_cache({k: t[u] for k, t in cache["units"]["b0"].items()},
                    {k: t[u] for k, t in jcache["units"]["b0"].items()})


def test_chunked_prefill_ragged_and_suffix(qwen):
    """Three lanes at different cursors through one chunk of 4 with
    ragged real rows (the JAX step vmaps batch-1 lanes), then a suffix
    prefill of every lane's next 3 tokens over the resident cache."""
    jcfg, jparams, cfg, params = qwen
    cap, w = 12, 4
    prefix = _tokens(3, (3, 8))
    pos = np.asarray([2, 5, 8], np.int32)
    valid = np.asarray([4, 2, 3], np.int32)
    chunk = _tokens(4, (3, w))
    jcaches = jax_stack_lane_caches(jcfg, 3, cap)
    lanes = []
    for i, p in enumerate(pos):
        row = prefix[i:i + 1, :p]
        _, _, c = jax_model.forward(jparams, jcfg, jnp.asarray(row),
                                    cache=jax_model.init_cache(jcfg, 1, cap))
        jcaches = jax.tree_util.tree_map(lambda a, b: a.at[i].set(b), jcaches, c)
        lanes.append(model.init_cache(cfg, 1, cap, device="cpu"))
        model.forward(params, cfg, torch.from_numpy(row), cache=lanes[i])
    cache = {"units": {"b0": {k: torch.cat([c["units"]["b0"][k] for c in lanes], dim=1)
                              for k in lanes[0]["units"]["b0"]}}}
    want, jcaches = jax_prefill_chunk_step(jparams, jcfg, jnp.asarray(chunk), jcaches,
                                           jnp.asarray(pos), chunk_valid=jnp.asarray(valid))
    got, cache = engine.prefill_chunk_step(params, cfg, torch.from_numpy(chunk), cache,
                                           torch.from_numpy(pos), torch.from_numpy(valid))
    want = np.asarray(want)
    for i, v in enumerate(valid):
        np.testing.assert_allclose(got[i, :v].numpy(), want[i, :v], **TOL)
        # lane i's real rows' codes and scales (jcaches: lane-first)
        end = pos[i] + v
        _same_cache({k: t[:, i, :end] if k != "len" else t[:, i]
                     for k, t in cache["units"]["b0"].items()},
                    {k: np.asarray(t)[i, :, 0, :end] if k != "len" else np.asarray(t)[i, :, 0]
                     for k, t in jcaches["units"]["b0"].items()})
    assert cache["units"]["b0"]["len"][0].tolist() == (pos + valid).tolist()
    # a suffix prefill of 3 tokens a lane from each lane's fill
    fill = pos + valid
    suffix = _tokens(5, (3, 3))
    got = engine.prefill_suffix_step(params, cfg, torch.from_numpy(suffix), cache,
                                     torch.from_numpy(fill))[0]
    for i in range(3):
        lane = jax.tree_util.tree_map(lambda a: a[i], jcaches)
        want, _ = jax_prefill_suffix_step(jparams, jcfg, jnp.asarray(suffix[i:i + 1]), lane,
                                          int(fill[i]))
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want), **TOL)


def test_paged_decode_plain_route(qwen):
    """A decode step against random int8 pools (codes and scales) for 3
    live lanes and a pad lane: against JAX ``serve_step_paged`` (whose
    quant branch takes the gather whatever ``kernel`` says); the codes
    and scales written; the kernel route refused."""
    jcfg, jparams, cfg, params = qwen
    r = np.random.default_rng(7)
    u, kh, hd, bs, p = cfg.pattern_units, cfg.num_kv_heads, cfg.head_dim, 4, 12
    pools = {n: r.integers(-127, 128, (u, p + 1, bs, kh, hd)).astype(np.int8)
             for n in ("k", "v")}
    pools.update({f"{n}_scale": r.uniform(0.001, 0.05, (u, p + 1, bs, kh, 1))
                  .astype(np.float32) for n in ("k", "v")})
    pos = np.asarray([5, 13, 2, 0], np.int32)
    tables = np.full((4, 4), p, np.int32)
    perm = r.permutation(p)
    tables[0, :2], tables[1, :4], tables[2, :1] = perm[:2], perm[2:6], perm[6:7]
    toks = r.integers(0, 500, (4, 1)).astype(np.int32)
    jcache = {"units": {"b0": {**{n: jnp.asarray(t)[:, None] for n, t in pools.items()},
                               "len": jnp.zeros((u, 4), jnp.int32)}}}
    want, jcache = jax_serve_step_paged(jparams, jcfg, jnp.asarray(toks), jcache,
                                        jnp.asarray(tables), jnp.asarray(pos), kernel="off")

    def port_cache():
        return {"units": {"b0": {**{n: torch.from_numpy(t.copy()) for n, t in pools.items()},
                                 "len": torch.zeros((u, 4), dtype=torch.int32)}}}

    cache = port_cache()
    got, cache = engine.serve_step_paged(params, cfg, torch.from_numpy(toks), cache,
                                         torch.from_numpy(tables), torch.from_numpy(pos),
                                         kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the written tokens (null block excluded)
    _same_cache({n: t[:, :p] if n != "len" else t for n, t in cache["units"]["b0"].items()},
                {n: np.asarray(t)[:, 0, :p] if n != "len" else t
                 for n, t in jcache["units"]["b0"].items()})
    assert cache["units"]["b0"]["len"].tolist() == [[1] * 4] * u
    with pytest.raises(ValueError, match="read float K/V"):
        engine.serve_step_paged(params, cfg, torch.from_numpy(toks), port_cache(),
                                torch.from_numpy(tables), torch.from_numpy(pos), kernel=True)


RING = 8


def test_ring_chunk_valid_and_decode():
    """recurrentgemma-2b's attention block on an 8-slot int8 ring: chunks
    of 6 with ``attend_cache`` (the second wraps it), per-lane
    ``chunk_valid`` whose pad rows write back the resident codes and
    scales, then decode steps over the wrapped ring."""
    name = "recurrentgemma-2b"
    jcfg = jax_smoke_variant(jax_get_config(name)).replace(kv_cache_int8=True)
    cfg = smoke_variant(get_config(name)).replace(kv_cache_int8=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = model.params_from_jax(jax_flatten_params(jparams), device="cpu")
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["units"]["b2"]["mixer"])
    tp = {k: v[0] for k, v in params["units"]["b2"]["mixer"].items()}
    jc = jax_layers.init_attn_cache(jcfg, 2, RING, jnp.float32)
    tc = layers.init_attn_cache(cfg, 2, RING, torch.float32, "cpu")
    r = np.random.default_rng(11)
    pos = 0
    for valid in ((6, 6), (4, 6), (6, 5)):
        x = (r.standard_normal((2, 6, cfg.d_model)) * 0.5).astype(np.float32)
        cv = np.asarray(valid, np.int32)
        before = {n: t.clone() for n, t in tc.items()}
        want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, pos=pos,
                                              window=RING, attend_cache=True,
                                              chunk_valid=jnp.asarray(cv))
        got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc, pos=pos,
                                         window=RING, attend_cache=True,
                                         chunk_valid=torch.from_numpy(cv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _same_cache(tc, jc)
        if valid[0] < 6:                      # lane 0's pad rows kept their slots
            slots = [(pos + i) % RING for i in range(valid[0], 6)]
            for n in QUANT:
                assert torch.equal(tc[n][0, slots], before[n][0, slots]), n
        pos += 6
    for step in range(3):
        x = (r.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
        want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, pos=pos,
                                              window=RING)
        got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc, pos=pos,
                                         window=RING)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _same_cache(tc, jc)
        pos += 1


@pytest.mark.parametrize("name", ["qwen2.5-3b", "musicgen-large"])
def test_pool_pages_scales_and_block_bytes(name):
    """The pool pages all four per-token leaves (the (…, KH, 1) scales in
    ``leaves``, only ``len`` in ``state``); ``block_bytes`` counts codes
    and scales, as the JAX pool's does on the smoke variant; at full
    width (on the meta device) musicgen-large's is 69,632 B a layer
    against 131,072 B in bf16."""
    jcfg = jax_smoke_variant(jax_get_config(name)).replace(kv_cache_int8=True)
    cfg = smoke_variant(get_config(name)).replace(kv_cache_int8=True)
    pool = PagedCachePool(cfg, 3, 12, 4, 9, device="cpu")
    assert set(pool.leaves) == {f"units/b0/{n}" for n in QUANT}
    assert set(pool.state) == {"units/b0/len"} and pool.prefix_cacheable
    assert tuple(pool.k_scale.shape) == (cfg.pattern_units, 10, 4, cfg.num_kv_heads, 1)
    assert pool.block_bytes == JaxPagedCachePool(jcfg, 3, 12, 4, 9).block_bytes
    full = get_config(name)
    int8 = PagedCachePool(full.replace(kv_cache_int8=True), 8, 96, 16, 48, device="meta")
    bf16 = PagedCachePool(full, 8, 96, 16, 48, device="meta")
    layer = 16 * full.num_kv_heads * (2 * full.head_dim + 2 * 4)
    assert int8.block_bytes == full.num_layers * layer
    assert bf16.block_bytes == full.num_layers * 16 * full.num_kv_heads * full.head_dim * 4
    if name == "musicgen-large":
        assert (layer, bf16.block_bytes // full.num_layers) == (69_632, 131_072)


def _gateway(cfg, params, **kw):
    return LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                           device="cpu", **{**GEOMETRY, **kw})


def _drain(gw, stream, new=6):
    reqs = [gw.submit(p, license=t, max_new_tokens=new - i % 2)
            for i, (t, p) in enumerate(stream)]
    gw.run()
    assert all(r.state.value == RequestState.DONE.value for r in reqs), \
        [r.error for r in reqs]
    return reqs


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_gateway_tokens_match_jax(qwen, mode):
    """A mixed-tier stream with preemptions through both gateways with
    int8 KV, on float views and on materialized int8 views: identical
    greedy tokens, schedule and counters; the prefix cache off."""
    jcfg, jparams, cfg, params = qwen
    views = {} if mode == "float" else dict(quantized=True, materialize_int8_views=True)
    stream = _stream(seed=3)
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     prefix_cache=False, telemetry=False, **GEOMETRY, **views)
    jreqs = _drain(jgw, stream)
    gw = _gateway(cfg, params, prefix_cache=False, **views)
    reqs = _drain(gw, stream)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert list(gw.trace) == list(jgw.trace)
    for key in ("preempted", "decode_steps", "prefill_chunks", "tokens_generated"):
        assert gw.stats[key] == jgw.stats[key], key
    assert gw.stats["preempted"] > 0


def test_prefix_hits_equal_the_cold_run(qwen):
    """With the prefix cache, retained int8 blocks (codes and scales)
    serve later prompts: tokens equal the cache-off run, with hits,
    copy-on-write copies of shared tail blocks and, on the 9-block pool,
    evictions of retained blocks."""
    _, _, cfg, params = qwen
    stream = _stream(seed=4)
    cold = _drain(_gateway(cfg, params, prefix_cache=False), stream)
    gw = _gateway(cfg, params)
    warm = []
    for half in (stream[:4], stream[4:]):      # the second wave finds the first's prefixes
        warm += _drain(gw, half)
    assert [r.out_tokens for r in warm] == [r.out_tokens for r in cold]
    assert gw.stats["prefix_tokens_reused"] > 0 and gw.stats["cow_copies"] > 0
    assert gw.prefix.stats()["evicted_blocks"] > 0


def test_graph_route_captures_the_plain_gather(qwen, monkeypatch):
    """The compiled decode and prefill steps over an int8 cache (the
    card's route, here through the recording backend): tokens equal the
    eager gateway's, and neither paged kernel's wrapper is called."""
    from repro_torch.kernels import paged_attention as kernels_pa

    _, _, cfg, params = qwen
    stream = _stream(seed=5)
    eager = _drain(_gateway(cfg, params), stream)
    gw = _gateway(cfg, params)
    assert not gw.decode_kernels and gw.kernel_decode and gw._graphs is None  # the CPU
    gw._graphs = DecodeGraphs(gw.slot, backend=Recorder())
    gw._prefill_graphs = PrefillGraphs(gw.slot, backend=gw._graphs.backend)
    calls = []
    for name in ("paged_attention", "paged_decode_write"):
        monkeypatch.setattr(kernels_pa, name, lambda *a, name=name: calls.append(name))
    reqs = _drain(gw, stream)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in eager]
    assert gw._graphs.captures > 0 and gw._prefill_graphs.captures > 0
    assert gw._graphs.replays == gw.stats["resident_decode_steps"] > gw._graphs.captures
    assert calls == []


def test_decode_kernels_refused(qwen):
    _, _, cfg, params = qwen
    with pytest.raises(ValueError, match="float KV cache"):
        _gateway(cfg, params, decode_kernels=True)
    with pytest.raises(ValueError, match="float KV cache"):
        _gateway(cfg, params, decode_pallas="pallas")
    gw = _gateway(cfg, params)
    assert not gw.decode_kernels
    assert gw.metrics()["decode_path"]["pallas"] == "off"
