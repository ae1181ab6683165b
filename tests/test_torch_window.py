"""Sliding-window attention and the pools' mixed cache trees in the port,
against the JAX package, on the CPU.

* ``layers.attention_core`` with ``window``, ``kv_len`` and per-slot
  ``k_positions`` (empty ring slots negative);
* ``layers.attention_block`` on a ring cache: the chunked prefill's
  pre-write snapshot, ``old_pos`` and the pad rows' write-back under
  ``chunk_valid``, a prefill of as many tokens as the ring has slots and
  of more, and decode over the wrapped ring;
* ``PagedCachePool`` on recurrentgemma-2b (paged K/V beside RG-LRU
  lane state and tail blocks; the probe's edge, where one more block
  would cross the window; ``NoPagedLeavesError``) and on mamba2-130m,
  and the contiguous ``CachePool`` on both.

Weights are the JAX package's (smoke recurrentgemma-2b, its attention
block ``units/b2``); inputs come from numpy seeds.  Outputs and caches
at atol = rtol = 1e-4 in f32 (as ``test_torch_model.py``); the pools'
bytes, shapes and round trips exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.pytree_io import unflatten_like as jax_unflatten_like
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.serving.paging import NoPagedLeavesError as JaxNoPagedLeavesError
from repro.serving.paging import PagedCachePool as JaxPagedCachePool
from repro.serving.scheduler import CachePool as JaxCachePool

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.models import layers, model
from repro_torch.serving.paging import NoPagedLeavesError, PagedCachePool
from repro_torch.serving.scheduler import CachePool
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
RING = 8            # ring slots (= the window) of the attention cases


@pytest.fixture(scope="module")
def attn():
    jcfg = jax_smoke_variant(jax_get_config("recurrentgemma-2b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("recurrentgemma-2b"))
    params = model.params_from_jax(jax_flatten_params(jparams), device="cpu")
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["units"]["b2"]["mixer"])
    tp = {k: v[0] for k, v in params["units"]["b2"]["mixer"].items()}
    return jcfg, jp, cfg, tp


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _caches(cfg, b, cap):
    shape = (b, cap, cfg.num_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape), "len": jnp.zeros((b,), jnp.int32)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "len": torch.zeros((b,), dtype=torch.int32)}
    return jc, tc


def _same_cache(got, want):
    for k in ("k", "v", "len"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_core_window_kv_len_and_k_positions(window):
    b, sq, sk, h, kh, hd = 2, 3, 12, 4, 2, 8
    q, k, v = _rand(0, (b, sq, h, hd)), _rand(1, (b, sk, kh, hd)), _rand(2, (b, sk, kh, hd))
    kp = np.asarray([7, 8, 9, 10, -1, -1, 11, 12, 13, 14, 3, 4], np.int32)
    for kw in (dict(), dict(kv_len=np.asarray([9, 12], np.int32)),
               dict(k_positions=kp)):
        want = jax_layers.attention_core(
            *(jnp.asarray(t) for t in (q, k, v)), q_offset=12, window=window,
            **{n: jnp.asarray(t) for n, t in kw.items()})
        got = layers.attention_core(
            *(torch.from_numpy(t) for t in (q, k, v)), q_offset=12, window=window,
            **{n: torch.from_numpy(t) for n, t in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ring_chunked_prefill_snapshot_and_pad_rows(attn):
    """Chunks of 6 with ``attend_cache`` into an 8-slot ring: the second
    wraps it (its earliest queries read the snapshot of slots its own
    writes evict), with per-lane ``chunk_valid`` 4 and 6 (the pad rows
    write back what their slot held); then decode steps over the wrapped
    ring (``window=0`` with ``len``)."""
    jcfg, jp, cfg, tp = attn
    jc, tc = _caches(cfg, 2, RING)
    pos = 0
    for i, valid in enumerate(((6, 6), (4, 6), (6, 5))):
        x = _rand(10 + i, (2, 6, cfg.d_model), 0.5)
        cv = np.asarray(valid, np.int32)
        want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, pos=pos,
                                              window=RING, attend_cache=True,
                                              chunk_valid=jnp.asarray(cv))
        got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc, pos=pos,
                                         window=RING, attend_cache=True,
                                         chunk_valid=torch.from_numpy(cv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _same_cache(tc, jc)
        pos += 6
    for step in range(3):
        x = _rand(20 + step, (2, 1, cfg.d_model), 0.5)
        want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, pos=pos,
                                              window=RING)
        got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc, pos=pos,
                                         window=RING)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _same_cache(tc, jc)
        pos += 1


def test_ring_chunked_prefill_per_lane_cursors(attn):
    """The port's lanes at their own cursors (``pos`` (B,)) in one call
    against the JAX block on each lane alone (the JAX gateway vmaps
    batch-1 lanes)."""
    jcfg, jp, cfg, tp = attn
    starts = np.asarray([2, 7], np.int32)
    prefill = _rand(30, (2, 7, cfg.d_model), 0.5)
    chunk = _rand(31, (2, 5, cfg.d_model), 0.5)
    _, tc = _caches(cfg, 2, RING)
    jcs = []
    for lane, s0 in enumerate(starts):
        jc, one = _caches(cfg, 1, RING)
        _, jc = jax_layers.attention_block(jp, jnp.asarray(prefill[lane:lane + 1, :s0]), jcfg,
                                           cache=jc, pos=0, window=RING, attend_cache=True)
        _, one = layers.attention_block(tp, torch.from_numpy(prefill[lane:lane + 1, :s0]),
                                        cfg, cache=one, pos=0, window=RING, attend_cache=True)
        for k in tc:
            tc[k][lane] = one[k][0]
        jcs.append(jc)
    got, tc = layers.attention_block(tp, torch.from_numpy(chunk), cfg, cache=tc,
                                     pos=torch.from_numpy(starts), window=RING,
                                     attend_cache=True,
                                     chunk_valid=torch.tensor([5, 3], dtype=torch.int32))
    for lane, (s0, valid) in enumerate(zip(starts, (5, 3))):
        want, jc = jax_layers.attention_block(jp, jnp.asarray(chunk[lane:lane + 1]), jcfg,
                                              cache=jcs[lane], pos=int(s0), window=RING,
                                              attend_cache=True, chunk_valid=valid)
        np.testing.assert_allclose(got[lane:lane + 1].numpy(), np.asarray(want), **TOL)
        _same_cache({k: t[lane:lane + 1] for k, t in tc.items()}, jc)


@pytest.mark.parametrize("length", [RING, 13])
def test_ring_prefill_at_and_past_the_ring(attn, length):
    """A prefill from empty of exactly ``cap`` tokens and of more (only the last ``cap`` positions land, each in
    its own slot), then two decode steps."""
    jcfg, jp, cfg, tp = attn
    jc, tc = _caches(cfg, 2, RING)
    x = _rand(40, (2, length, cfg.d_model), 0.5)
    want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, pos=0,
                                          window=RING)
    got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc, pos=0,
                                     window=RING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc, jc)
    for step in range(2):
        x = _rand(41 + step, (2, 1, cfg.d_model), 0.5)
        want, jc = jax_layers.attention_block(jp, jnp.asarray(x), jcfg, cache=jc,
                                              pos=length + step, window=RING)
        got, tc = layers.attention_block(tp, torch.from_numpy(x), cfg, cache=tc,
                                         pos=length + step, window=RING)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _same_cache(tc, jc)


# ----------------------------------------------------------------- pools
def _configs(name, layers_=None):
    jcfg, cfg = jax_smoke_variant(jax_get_config(name)), smoke_variant(get_config(name))
    if layers_:
        jcfg, cfg = jcfg.replace(num_layers=layers_), cfg.replace(num_layers=layers_)
    return jcfg, cfg


def _jax_views(tree):
    """The JAX pool's lane-stacked batch-1 views as the port's batch
    layout, by path: a unit leaf (lane, U, 1, ...) -> (U, lane, ...), a
    tail leaf (lane, 1, ...) -> (lane, ...)."""
    out = {}
    for name, x in jax_flatten_params(tree).items():
        x = np.asarray(x, np.float32)
        out[name] = np.moveaxis(x[:, :, 0], 0, 1) if name.startswith("units/") else x[:, 0]
    return out


@pytest.mark.parametrize("capacity,block", [(16, 8), (20, 4), (24, 12), (40, 8)])
def test_paged_pool_classifies_like_jax(capacity, block):
    """recurrentgemma-2b (window 32, 5 layers): the pool pages K/V while
    the padded capacity and one block more stay within the window, and
    keeps the ring as lane state (so nothing is paged: the JAX error)
    when the extra block crosses it (24 tokens + 12 > 32) or the
    capacity is past it."""
    jcfg, cfg = _configs("recurrentgemma-2b", 5)
    geometry = (3, capacity, block, 2 * -(-capacity // block))
    try:
        jpool = JaxPagedCachePool(jcfg, *geometry)
    except JaxNoPagedLeavesError:
        with pytest.raises(NoPagedLeavesError):
            PagedCachePool(cfg, *geometry, device="cpu")
        assert (capacity, block) in ((24, 12), (40, 8))
        return
    pool = PagedCachePool(cfg, *geometry, device="cpu")
    assert set(pool.leaves) == {"units/b2/k", "units/b2/v"}
    assert sorted(pool.state) == ["tail/t0/conv", "tail/t0/state", "tail/t1/conv",
                                  "tail/t1/state", "units/b0/conv", "units/b0/state",
                                  "units/b1/conv", "units/b1/state", "units/b2/len"]
    assert (pool.nbytes, pool.block_bytes) == (jpool.nbytes, jpool.block_bytes)
    assert pool.prefix_cacheable is jpool.prefix_cacheable is False
    assert tuple(pool.state["units/b2/len"].shape) == (4, cfg.pattern_units)


def test_paged_pool_round_trips_like_jax():
    """Random lane caches scattered into both pools through the same
    tables and lanes, gathered back (with lanes, and fresh without),
    through ``decode_cache``/``absorb_decode`` and ``override_counters``:
    the port's views equal the JAX pool's."""
    jcfg, cfg = _configs("recurrentgemma-2b", 5)
    geometry = (3, 16, 8, 6)
    jpool, pool = JaxPagedCachePool(jcfg, *geometry), PagedCachePool(cfg, *geometry,
                                                                      device="cpu")
    lanes, tables = [2, 0], np.asarray([[4, 1], [0, 5]], np.int32)
    shapes = {n: tuple(t.shape) for n, t in flatten_params(
        model.init_cache(cfg, 2, pool.padded_capacity, device="cpu")).items()}
    rng = np.random.default_rng(0)
    new = {n: (rng.integers(0, 9, s).astype(np.int32) if n.endswith("len")
               else rng.standard_normal(s).astype(np.float32)) for n, s in shapes.items()}
    jflat = {}
    for n, a in new.items():
        x = a[:, :, None] if n.startswith("units/") else a[:, None]
        jflat[n] = jnp.asarray(np.moveaxis(x, 1, 0) if n.startswith("units/") else x)
    jnew = jax_unflatten_like(jpool.gather(lanes, tables), jflat)
    jpool.scatter(lanes, tables, jnew)
    pool.scatter(lanes, tables, unflatten({n: torch.from_numpy(a) for n, a in new.items()}))
    for fresh in (False, True):
        want = _jax_views(jpool.gather(lanes, tables, fresh_lane_state=fresh))
        got = flatten_params(pool.gather(tables, None if fresh else lanes))
        assert list(got) == sorted(want)
        for n, t in got.items():
            np.testing.assert_array_equal(t.float().numpy(), want[n], err_msg=n)
    dc = pool.decode_cache(lanes)
    assert dc["units"]["b2"]["k"] is pool.k
    np.testing.assert_array_equal(dc["tail"]["t1"]["state"].numpy(), new["tail/t1/state"])
    dc["tail"]["t1"]["state"] = dc["tail"]["t1"]["state"] + 1
    pool.absorb_decode(lanes, dc)
    np.testing.assert_array_equal(pool.state["tail/t1/state"][lanes].numpy(),
                                  new["tail/t1/state"] + 1)
    pinned = flatten_params(pool.override_counters(pool.gather(tables, lanes), [7, 9]))
    assert pinned["units/b2/len"].tolist() == [[7, 9]] * cfg.pattern_units
    np.testing.assert_array_equal(pinned["units/b0/state"].numpy(), new["units/b0/state"])


@pytest.mark.parametrize("name,layers_", [("mamba2-130m", None), ("recurrentgemma-2b", 5)])
def test_contiguous_pool_like_jax(name, layers_):
    """The contiguous pool: every leaf of the model's cache with the lane
    at its own batch axis (the tail's first); the JAX pool's bytes; a
    scatter then gather round trip; mamba2-130m has nothing to page."""
    jcfg, cfg = _configs(name, layers_)
    jpool, pool = JaxCachePool(jcfg, 3, 20), CachePool(cfg, 3, 20, device="cpu")
    assert pool.nbytes == jpool.nbytes
    if name == "mamba2-130m":
        with pytest.raises(NoPagedLeavesError):
            PagedCachePool(cfg, 3, 20, 4, 10, device="cpu")
        with pytest.raises(JaxNoPagedLeavesError):
            JaxPagedCachePool(jcfg, 3, 20, 4, 10)
    batch = model.init_cache(cfg, 2, 20, device="cpu")
    for n, t in flatten_params(batch).items():
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    pool.scatter([2, 0], batch)
    back = flatten_params(pool.gather([2, 0]))
    for n, t in flatten_params(batch).items():
        assert torch.equal(back[n], t), n
    assert tuple(pool.leaves["units/b0/state" if name == "mamba2-130m"
                             else "tail/t0/state"].shape)[:2] == (
        (cfg.pattern_units, 4) if name == "mamba2-130m" else (4, cfg.lru_width))
