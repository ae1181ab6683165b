"""The port's MoE block and deepseek-moe-16b against the JAX package, on
the CPU.

Weights are the JAX package's ``init_params(PRNGKey(0), smoke
deepseek-moe-16b)`` (4 experts, top-2, one shared expert, MHA at 4/4
heads) carried across with ``params_from_jax``; inputs come from numpy
seeds, in f32.

* ``moe_block`` against ``repro.models.moe.moe_block``: the routing
  (``top_e``) identical, y at atol = rtol = 1e-5 and the aux loss at
  rtol 1e-5.  The smoke variant's capacity factor (4.0) never drops a
  token, so the drop case runs its own config at capacity factor 1.0
  with a router biased toward two experts: the drops counted by the
  port's dispatch equal those of the JAX package's formula and are
  above 0, and y still agrees (a dropped token must add nothing to the
  kept one sharing its parked slot).
* The default ``LicensedGateway`` (chunked prefill into the paged pool,
  the kernel-resident decode on its plain route on the CPU) against the
  JAX gateway on one stream with preemptions, with the prefix cache off
  and on, and the contiguous ``paged=False`` fallback: identical greedy
  tokens and schedule trace.
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
from repro.models import moe as jax_moe
from repro.serving import LicensedGateway as JaxGateway

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import moe
from repro_torch.models.model import init_params, params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-moe-16b"
TOL = dict(atol=1e-5, rtol=1e-5)
FREE = {"*": ((0.0, 0.01),)}
# a small pool (block_size 4, 9 blocks for 3 lanes): preemption and
# prefix reuse happen, as in tests/test_torch_gateway.py
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)
STREAM = [("full", 7), ("free", 5), ("full", 11), ("free", 9), ("full", 3), ("free", 10)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config(ARCH))
    return jcfg, jparams, cfg, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _ffn(jparams, params):
    """Unit 0's MoE leaves in both packages."""
    jffn = jax.tree_util.tree_map(lambda a: a[0], jparams["units"]["b0"]["ffn"])
    ffn = jax.tree_util.tree_map(lambda t: t[0], params["units"]["b0"]["ffn"])
    return jffn, ffn


def _jax_drops(p, x, cfg):
    """Tokens the JAX package's per-row dispatch drops, by its formula."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"]), -1)
    _, top_e = jax.lax.top_k(probs, cfg.experts_per_token)
    b, s, _ = x.shape
    cap = max(int(np.ceil(s * cfg.experts_per_token / cfg.num_experts
                          * cfg.moe_capacity_factor)), 8)
    onehot = jax.nn.one_hot(top_e.reshape(b, -1), cfg.num_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return int(jnp.sum(pos >= cap))


def test_params_carry_the_router_in_f32(weights):
    jcfg, jparams, cfg, params = weights
    ffn = params["units"]["b0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["experts"]["w_gate"].shape) == (1 * cfg.pattern_units, cfg.num_experts,
                                                     cfg.d_model, cfg.moe_d_ff)
    assert tuple(ffn["shared"]["w_up"].shape[1:]) == (
        cfg.d_model, cfg.moe_d_ff * cfg.num_shared_experts)
    # the port's own init: the router f32 in a bf16 model, shapes as JAX's
    own = init_params(cfg.replace(dtype_name="bfloat16"), seed=0, device="cpu")
    want = jax_flatten_params(jax_init_params(jax.random.PRNGKey(0),
                                              jcfg.replace(dtype_name="bfloat16")))
    got = flatten_params(own)
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


@pytest.mark.parametrize("shape", [(2, 9), (3, 1), (1, 24)])
def test_moe_block_matches_jax(weights, shape):
    """Prefill-sized rows, decode-sized rows (S = 1, 3 lanes) and one
    long row."""
    jcfg, jparams, cfg, params = weights
    jffn, ffn = _ffn(jparams, params)
    x = np.random.default_rng(sum(shape)).standard_normal((*shape, cfg.d_model)).astype(
        np.float32)
    want, jaux = jax_moe.moe_block(jffn, jnp.asarray(x), jcfg)
    got, aux = moe.moe_block(ffn, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), jffn["router"]), -1)
    _, jtop = jax.lax.top_k(probs, jcfg.experts_per_token)
    _, _, top_e = moe.route(ffn, torch.from_numpy(x), cfg)
    assert top_e.tolist() == np.asarray(jtop).tolist()


def test_moe_block_drops_tokens_like_jax(weights):
    """Capacity factor 1.0 and a router that sends most tokens to experts
    0 and 1: 2 rows of 16 tokens, capacity max(ceil(16 * 2 / 4), 8) = 8
    slots an expert, so tokens are dropped; the port drops the same
    count and gives the same output."""
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = (c.replace(moe_capacity_factor=1.0) for c in (jcfg, cfg))
    rng = np.random.default_rng(7)
    d, e = cfg.d_model, cfg.num_experts
    base = rng.standard_normal(d).astype(np.float32)
    x = (base + 0.5 * rng.standard_normal((2, 16, d))).astype(np.float32)
    router = (0.02 * rng.standard_normal((d, e))).astype(np.float32)
    router[:, 0] += 0.05 * base / np.linalg.norm(base)
    router[:, 1] += 0.04 * base / np.linalg.norm(base)
    jffn, ffn = _ffn(jparams, params)
    jffn = {**jffn, "router": jnp.asarray(router)}
    ffn = {**ffn, "router": torch.from_numpy(router)}
    want, jaux = jax_moe.moe_block(jffn, jnp.asarray(x), jcfg)
    got, aux = moe.moe_block(ffn, torch.from_numpy(x), cfg)
    _, _, top_e = moe.route(ffn, torch.from_numpy(x), cfg)
    _, _, keep = moe.dispatch(top_e, e, moe.capacity(16, cfg))
    drops = int((~keep).sum())
    assert drops == _jax_drops(jffn, jnp.asarray(x), jcfg) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------- gateways
def _drain(gw):
    reqs = [gw.submit(np.random.default_rng(100 + i).integers(0, 500, n, dtype=np.int32),
                      license=tier, max_new_tokens=6 + i % 3)
            for i, (tier, n) in enumerate(STREAM)]
    gw.run()
    return reqs


# the port's default gateway (prefix cache on), the same with it off, and
# the contiguous pool (which has no prefix cache)
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
    assert (tgw.prefix is not None) == (name == "default")
