"""The port's multi-head latent attention (MLA), deepseek-v2-lite-16b and
the paged pool's leaves against the JAX package, on the CPU.

Weights are the JAX package's ``init_params(PRNGKey(0), smoke
deepseek-v2-lite-16b)`` (4 heads, kv_lora_rank 64, qk_nope 32, rope 16,
v 32; 4 experts, top-2) carried across with ``params_from_jax``; inputs
come from numpy seeds, in f32.  Tolerances: atol = rtol = 1e-5 on one
block's output and its cache leaves, 1e-4 on logits (as the dense cases).

* ``mla_block`` in prefill, decode with ``len``, and chunked prefill with
  ragged ``chunk_valid`` (three lanes at their own cursors; the JAX step
  runs each lane as a batch of one, as its ``vmap`` does), and
  ``mla_block_paged`` against ``repro.models.layers``' functions, the
  written cache leaves included.  The softmax scale is q's head dim
  (nope + rope = 48): no ``softmax_scale`` argument is needed.
* ``PagedCachePool``: the leaves, ``block_bytes`` and ``nbytes`` of the
  JAX pool for both DeepSeek configs and qwen2.5-3b, whose K/V layout is
  the dense one of before.
* The default ``LicensedGateway`` against the JAX gateway on one stream
  with preemptions, prefix cache off and on, and ``paged=False``.
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
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.paging import PagedCachePool as JaxPagedCachePool

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models import layers
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving.paging import PagedCachePool
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-5, rtol=1e-5)
FREE = {"*": ((0.0, 0.01),)}
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)
STREAM = [("full", 7), ("free", 5), ("full", 11), ("free", 9), ("full", 3), ("free", 10)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config(ARCH))
    return jcfg, jparams, cfg, params_from_jax(jax_flatten_params(jparams), device="cpu")


# the JAX blocks jit-compiled once (op by op they take seconds a call)
jax_mla_block = jax.jit(jax_layers.mla_block, static_argnums=(2,),
                        static_argnames=("attend_cache",))
jax_mla_block_paged = jax.jit(jax_layers.mla_block_paged, static_argnums=(2,))


def _mixer(jparams, params):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["units"]["b0"]["mixer"])
    p = {k: t[0] for k, t in params["units"]["b0"]["mixer"].items()}
    return jp, p


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_mla_leaves_and_scale(weights):
    """The mixer's keys and shapes are the JAX package's (``ckv_norm`` a
    bare leaf); the q/k head dim is nope + rope, whose 1/sqrt is the JAX
    ``softmax_scale``."""
    jcfg, jparams, cfg, params = weights
    jp, p = _mixer(jparams, params)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert tuple(p["ckv_norm"].shape) == (cfg.kv_lora_rank,)
    assert cfg.qk_nope_dim + cfg.rope_head_dim != cfg.v_head_dim


def test_mla_prefill_matches_jax(weights):
    jcfg, jparams, cfg, params = weights
    jp, p = _mixer(jparams, params)
    x = _x(0, 2, 9, cfg.d_model)
    want, _ = jax_mla_block(jp, jnp.asarray(x), jcfg)
    got, _ = layers.mla_block(p, torch.from_numpy(x), cfg)
    _close(got, want)


def test_mla_prefill_then_decode_matches_jax(weights):
    """A cache filled from empty by a 6-token prefill, then one decode
    token against ``len``; the cache leaves too."""
    jcfg, jparams, cfg, params = weights
    jp, p = _mixer(jparams, params)
    x, nxt, cap = _x(1, 2, 6, cfg.d_model), _x(2, 2, 1, cfg.d_model), 10
    jcache = jax_layers.init_mla_cache(jcfg, 2, cap, jnp.float32)
    cache = layers.init_mla_cache(cfg, 2, cap, torch.float32, "cpu")
    want, jcache = jax_mla_block(jp, jnp.asarray(x), jcfg, cache=jcache)
    got, cache = layers.mla_block(p, torch.from_numpy(x), cfg, cache=cache)
    _close(got, want)
    want, jcache = jax_mla_block(jp, jnp.asarray(nxt), jcfg, cache=jcache, pos=6)
    got, cache = layers.mla_block(p, torch.from_numpy(nxt), cfg, cache=cache, pos=6)
    _close(got, want)
    for key in ("ckv", "k_rope"):
        _close(cache[key], jcache[key])
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist() == [7, 7]


def test_mla_chunked_prefill_ragged_matches_jax(weights):
    """Three lanes at cursors 2, 5, 8 with 4, 2, 2 real rows of a width-4
    chunk: lane 2's junk rows (positions 10, 11) clamp onto the last slot
    (10).  Real rows and the cache leaves below each lane's last real
    position must agree; the counters are the lanes' fills."""
    jcfg, jparams, cfg, params = weights
    jp, p = _mixer(jparams, params)
    cap, w = 11, 4
    pos = np.asarray([2, 5, 8], np.int32)
    valid = np.asarray([4, 2, 2], np.int32)
    prefix = _x(3, 3, 8, cfg.d_model)
    chunk = _x(4, 3, w, cfg.d_model)
    cache = layers.init_mla_cache(cfg, 3, cap, torch.float32, "cpu")
    lanes = []
    for i, n in enumerate(pos):
        jc = jax_layers.init_mla_cache(jcfg, 1, cap, jnp.float32)
        _, jc = jax_mla_block(jp, jnp.asarray(prefix[i:i + 1, :n]), jcfg, cache=jc)
        lanes.append(jc)
        one = {k: v[i:i + 1] for k, v in cache.items()}
        _, one = layers.mla_block(p, torch.from_numpy(prefix[i:i + 1, :n]), cfg, cache=one)
        cache["len"][i] = one["len"][0]
    got, cache = layers.mla_block(p, torch.from_numpy(chunk), cfg, cache=cache,
                                  pos=torch.from_numpy(pos), attend_cache=True,
                                  chunk_valid=torch.from_numpy(valid))
    for i, (n, v) in enumerate(zip(pos, valid)):
        want, jc = jax_mla_block(jp, jnp.asarray(chunk[i:i + 1]), jcfg, cache=lanes[i],
                                 pos=int(n), attend_cache=True, chunk_valid=int(v))
        _close(got[i, :v], np.asarray(want)[0, :v])
        for key in ("ckv", "k_rope"):
            _close(cache[key][i, : n + v], np.asarray(jc[key])[0, : n + v])
    assert cache["len"].tolist() == [6, 7, 10]


def test_mla_block_paged_matches_jax(weights):
    """One decode token a lane against random physical blocks: 3 live
    lanes and a pad lane on the null block; output and every written
    block (the null block excluded) against the JAX function."""
    jcfg, jparams, cfg, params = weights
    jp, p = _mixer(jparams, params)
    r = np.random.default_rng(5)
    bs, nb = 4, 12
    ckv = r.standard_normal((nb + 1, bs, cfg.kv_lora_rank)).astype(np.float32)
    kr = r.standard_normal((nb + 1, bs, cfg.rope_head_dim)).astype(np.float32)
    pos = np.asarray([5, 13, 2, 0], np.int32)
    tables = np.full((4, 4), nb, np.int32)
    perm = r.permutation(nb)
    tables[0, :2], tables[1, :4], tables[2, :1] = perm[:2], perm[2:6], perm[6:7]
    x = _x(6, 4, 1, cfg.d_model)
    jcache = {"ckv": jnp.asarray(ckv)[None], "k_rope": jnp.asarray(kr)[None],
              "len": jnp.zeros((4,), jnp.int32)}
    want, jcache = jax_mla_block_paged(jp, jnp.asarray(x), jcfg, cache=jcache,
                                              tables=jnp.asarray(tables),
                                              pos=jnp.asarray(pos))
    cache = {"ckv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(kr.copy()),
             "len": torch.zeros((4,), dtype=torch.int32)}
    got, cache = layers.mla_block_paged(p, torch.from_numpy(x), cfg, cache=cache,
                                        tables=torch.from_numpy(tables),
                                        pos=torch.from_numpy(pos))
    _close(got, want)
    for key in ("ckv", "k_rope"):
        _close(cache[key][:nb], np.asarray(jcache[key])[0, :nb])
    assert cache["len"].tolist() == [1, 1, 1, 1]


# ---------------------------------------------------------------- the pool
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b", "qwen2.5-3b"])
def test_paged_pool_leaves_match_jax(arch):
    """The pool's paged leaves are the JAX pool's with its batch-1 axis
    dropped; ``block_bytes`` (the fleet budget's exchange rate) and
    ``nbytes`` are equal, at smoke and at full width (the full widths on
    a one-block pool)."""
    for cfg, jcfg, geometry in (
            (smoke_variant(get_config(arch)), jax_smoke_variant(jax_get_config(arch)),
             (3, 20, 4, 8)),
            (get_config(arch), jax_get_config(arch), (1, 16, 16, 1))):
        pool = PagedCachePool(cfg, *geometry, device="cpu")
        jpool = JaxPagedCachePool(jcfg, *geometry)
        jleaves = jax.tree_util.tree_leaves_with_path(jpool.gather([0], jpool.pad_tables([], 1)))
        paged = {str(path[-1].key): leaf.shape for path, leaf in jleaves
                 if str(path[-1].key) != "len"}
        assert {path.split("/")[-1] for path in pool.leaves} == set(paged)
        for path, t in pool.leaves.items():
            name = path.split("/")[-1]
            jarr = jpool._storage[[str(p[-1].key) for p, _ in jleaves].index(name)]
            assert tuple(t.shape) == jarr.shape[:1] + jarr.shape[2:], name
            assert str(t.dtype).split(".")[-1] == str(jarr.dtype), name
        assert pool.block_bytes == jpool.block_bytes
        assert pool.nbytes == jpool.nbytes
        assert pool.prefix_cacheable == jpool.prefix_cacheable is True
    if arch == "qwen2.5-3b":
        full = PagedCachePool(get_config(arch), 1, 16, 16, 1, device="cpu")
        assert list(full.leaves) == ["units/b0/k", "units/b0/v"]
        assert full.k is full.leaves["units/b0/k"]
        assert tuple(full.k.shape) == (36, 2, 16, 2, 128)
    if arch == "deepseek-v2-lite-16b":       # (512 + 64) * 2 B * 27 units a token
        assert pool.block_bytes == (512 + 64) * 2 * 27 * 16


# ---------------------------------------------------------------- gateways
def _drain(gw):
    reqs = [gw.submit(np.random.default_rng(100 + i).integers(0, 500, n, dtype=np.int32),
                      license=tier, max_new_tokens=6 + i % 3)
            for i, (tier, n) in enumerate(STREAM)]
    gw.run()
    return reqs


GATEWAYS = {"default": {}, "prefix_off": dict(prefix_cache=False),
            "contiguous": dict(paged=False, prefix_cache=False)}


@pytest.fixture(scope="module", params=sorted(GATEWAYS))
def streams(request, weights):
    jcfg, jparams, cfg, params = weights
    kw = dict(GEOMETRY, **GATEWAYS[request.param])
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     telemetry=False, **kw)
    tgw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                          device="cpu", **kw)
    return request.param, jgw, _drain(jgw), tgw, _drain(tgw)


def test_gateway_tokens_and_schedule_identical(streams):
    name, jgw, jreqs, tgw, treqs = streams
    assert all(r.state is RequestState.DONE for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert list(tgw.trace) == list(jgw.trace)
    for key in ("completed", "tokens_generated", "decode_steps", "prefill_chunks",
                "preempted", "prefix_tokens_reused"):
        assert tgw.stats.get(key) == jgw.stats.get(key), key
    if name != "contiguous":
        assert tgw.stats["preempted"] > 0
        assert tgw.pool.block_bytes == jgw.pool.block_bytes
        assert set(tgw.pool.leaves) == {"units/b0/ckv", "units/b0/k_rope"}
    assert (tgw.prefix is not None) == (name == "default")
