"""The port's model (the dense GQA decoders and the DeepSeek MoE / MLA
ones) against ``repro.models.model.forward``.

Weights are the JAX package's ``init_params(PRNGKey(0), smoke qwen2.5-3b)``
carried across with ``params_from_jax``; inputs come from numpy seeds.
Logits are compared at atol = rtol = 1e-4 in f32: the two frameworks sum
the matrix products and softmaxes in different orders, and RoPE's
``theta ** x`` may differ in its last bit (observed error ~1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.serving.engine import prefill_chunk_step as jax_prefill_chunk_step
from repro.serving.engine import serve_step_paged as jax_serve_step_paged
from repro.serving.engine import stack_lane_caches

from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model
from repro_torch.serving.engine import prefill_chunk_step, serve_step_paged
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 500, shape, dtype=np.int32)


def test_config_fields_match_jax(weights):
    jcfg, _, cfg, _ = weights
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "rope_theta", "attn_bias",
              "layer_pattern", "pattern_units", "name"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_config("qwen2.5-3b")
    assert (full.num_layers, full.d_model, full.padded_vocab) == (36, 2048, 152064)
    assert full.dtype == torch.bfloat16


def test_one_shot_prefill(weights):
    jcfg, jparams, cfg, params = weights
    toks = _tokens(0, (2, 9))
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = model.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[..., cfg.vocab_size:] == -1e9).all()


def test_prefill_then_decode(weights):
    jcfg, jparams, cfg, params = weights
    toks, nxt, cap = _tokens(1, (2, 6)), _tokens(2, (2, 1)), 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    _, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache, pos=6)
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache, pos=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["units"]["b0"]["len"].tolist() == [[7, 7], [7, 7]]


def test_chunked_attend_cache_ragged(weights):
    """Three lanes at different cursors, one chunk of width 4 with ragged
    real-row counts: the JAX step vmaps batch-1 lanes, the port runs one
    batch with per-lane positions.  Junk rows are never compared; lane 2's
    two junk rows (positions 10 and 11) clamp onto the last slot (10),
    past its real rows."""
    jcfg, jparams, cfg, params = weights
    cap, w = 11, 4
    prefix = _tokens(3, (3, 8))
    pos = np.asarray([2, 5, 8], np.int32)
    valid = np.asarray([4, 2, 2], np.int32)
    chunk = _tokens(4, (3, w))
    # lane caches already holding each lane's first `pos` tokens
    jcaches = stack_lane_caches(jcfg, 3, cap)
    cache = model.init_cache(cfg, 3, cap, device="cpu")
    for i, p in enumerate(pos):
        row = prefix[i:i + 1, :p]
        _, _, c = jax_model.forward(jparams, jcfg, jnp.asarray(row),
                                    cache=jax_model.init_cache(jcfg, 1, cap))
        jcaches = jax.tree_util.tree_map(lambda a, b: a.at[i].set(b), jcaches, c)
    lanes = [model.init_cache(cfg, 1, cap, device="cpu") for _ in pos]
    for i, p in enumerate(pos):
        model.forward(params, cfg, torch.from_numpy(prefix[i:i + 1, :p]), cache=lanes[i])
    for key in ("k", "v", "len"):
        cache["units"]["b0"][key] = torch.cat(
            [c["units"]["b0"][key] for c in lanes], dim=1)
    want, _ = jax_prefill_chunk_step(jparams, jcfg, jnp.asarray(chunk), jcaches,
                                     jnp.asarray(pos), chunk_valid=jnp.asarray(valid))
    got, cache = prefill_chunk_step(params, cfg, torch.from_numpy(chunk), cache,
                                    torch.from_numpy(pos), torch.from_numpy(valid))
    want = np.asarray(want)
    for i, v in enumerate(valid):
        np.testing.assert_allclose(got[i, :v].numpy(), want[i, :v], **TOL)
    assert cache["units"]["b0"]["len"][0].tolist() == [6, 7, 10]


def _paged_case(jcfg, seed):
    """A decode step against a random pool: 3 live lanes + 1 pad lane."""
    r = np.random.default_rng(seed)
    u, kh, hd, bs, p = jcfg.pattern_units, jcfg.num_kv_heads, jcfg.head_dim, 4, 12
    pool_k = r.standard_normal((u, p + 1, bs, kh, hd)).astype(np.float32)
    pool_v = r.standard_normal((u, p + 1, bs, kh, hd)).astype(np.float32)
    pos = np.asarray([5, 13, 2, 0], np.int32)
    tables = np.full((4, 4), p, np.int32)              # null-padded
    perm = r.permutation(p)
    tables[0, :2], tables[1, :4], tables[2, :1] = perm[:2], perm[2:6], perm[6:7]
    toks = r.integers(0, 500, (4, 1)).astype(np.int32)
    return pool_k, pool_v, pos, tables, toks


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_paged_decode_matches_jax(weights, route):
    """Port paged decode vs JAX ``serve_step_paged``: the plain path
    against ``kernel="off"``, and the kernel route (whose wrappers take
    the plain versions on CPU tensors) against the Pallas kernels in
    interpret mode."""
    jcfg, jparams, cfg, params = weights
    pool_k, pool_v, pos, tables, toks = _paged_case(jcfg, 5)
    u, b = jcfg.pattern_units, len(pos)
    jcache = {"units": {"b0": {"k": jnp.asarray(pool_k)[:, None],
                               "v": jnp.asarray(pool_v)[:, None],
                               "len": jnp.zeros((u, b), jnp.int32)}}}
    want, jcache = jax_serve_step_paged(
        jparams, jcfg, jnp.asarray(toks), jcache, jnp.asarray(tables),
        jnp.asarray(pos), kernel="off" if route == "plain" else "interpret")
    cache = {"units": {"b0": {"k": torch.from_numpy(pool_k.copy()),
                              "v": torch.from_numpy(pool_v.copy()),
                              "len": torch.zeros((u, b), dtype=torch.int32)}}}
    got, cache = serve_step_paged(params, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(tables), torch.from_numpy(pos),
                                  kernel=route == "kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    null = pool_k.shape[1] - 1
    for key in ("k", "v"):       # the written tokens (null block excluded)
        np.testing.assert_allclose(cache["units"]["b0"][key][:, :null].numpy(),
                                   np.asarray(jcache["units"]["b0"][key])[:, 0, :null],
                                   atol=1e-5, rtol=1e-5)
    assert cache["units"]["b0"]["len"].tolist() == [[1] * b] * u


# the free tier of the gateway tests, and a tier with two intervals
IN_SCAN_TIERS = {"free": {"*": ((0.0, 0.01),)},
                 "banded": {"*": ((0.0, 0.004), (0.02, 0.03))}}


@pytest.mark.parametrize("tier", sorted(IN_SCAN_TIERS))
def test_in_scan_int8_forward(weights, tier):
    """``forward`` on the int8 store with a tier's ``license_intervals``
    (each unit dequantized with the mask fused in, inside the step):
    against the JAX ``forward`` on its own store of the same weights at
    the float tolerance above, and bit for bit against the port's
    ``forward`` on the tier's materialized view."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.serving.quantized import quantize_serving_params as jax_quantize
    from repro.serving.quantized import tier_intervals as jax_tier_intervals

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving import quantized

    jcfg, jparams, cfg, params = weights
    masks = IN_SCAN_TIERS[tier]
    toks = _tokens(6, (2, 9))
    want, _, _ = jax_model.forward(
        jax_quantize(jparams), jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name=tier, masks=masks)))
    store = quantized.quantize_serving_params(params)
    lt = LicenseTier(name=tier, masks=masks)
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(lt, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    view = quantized.materialize_licensed_view(store, lt, cfg.dtype)
    mat, _ = model.forward(view, cfg, torch.from_numpy(toks))
    assert torch.equal(got, mat)
    # a tier that masks nothing: no intervals, the unmasked dequant
    plain, _ = model.forward(store, cfg, torch.from_numpy(toks))
    full, _ = model.forward(quantized.materialize_licensed_view(store, None, cfg.dtype),
                            cfg, torch.from_numpy(toks))
    assert torch.equal(plain, full) and not torch.equal(plain, got)


# ------------------------------------------------------------ dense family
# every dense decoder the port runs: SwiGLU (qwen2.5-3b, granite-34b's MQA)
# and squared ReLU (minitron-8b, nemotron-4-15b), at their smoke variants
DENSE = ("granite-34b", "minitron-8b", "nemotron-4-15b", "qwen2.5-3b")


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    jcfg = jax_smoke_variant(jax_get_config(request.param))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config(request.param))
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def test_dense_config_fields_match_jax(dense):
    """Every field of the full config and of its smoke variant, ``source``
    included, equals the JAX package's."""
    import dataclasses

    jcfg, _, cfg, params = dense
    name = cfg.name[: -len("-smoke")]
    for got, want in ((get_config(name), jax_get_config(name)), (cfg, jcfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ffn = params["units"]["b0"]["ffn"]
    assert ("w_gate" in ffn) == (cfg.mlp_type == "swiglu")
    assert name in __import__("repro_torch.configs", fromlist=["x"]).list_configs()


def test_dense_one_shot_prefill(dense):
    jcfg, jparams, cfg, params = dense
    toks = _tokens(10, (2, 9))
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = model.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_prefill_then_decode(dense):
    jcfg, jparams, cfg, params = dense
    toks, nxt, cap = _tokens(11, (2, 6)), _tokens(12, (2, 1)), 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    _, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache, pos=6)
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    got, _ = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache, pos=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_paged_plain_route(dense):
    """The plain paged decode against JAX ``serve_step_paged(kernel="off")``."""
    jcfg, jparams, cfg, params = dense
    pool_k, pool_v, pos, tables, toks = _paged_case(jcfg, 13)
    u, b = jcfg.pattern_units, len(pos)
    jcache = {"units": {"b0": {"k": jnp.asarray(pool_k)[:, None],
                               "v": jnp.asarray(pool_v)[:, None],
                               "len": jnp.zeros((u, b), jnp.int32)}}}
    want, _ = jax_serve_step_paged(jparams, jcfg, jnp.asarray(toks), jcache,
                                   jnp.asarray(tables), jnp.asarray(pos), kernel="off")
    cache = {"units": {"b0": {"k": torch.from_numpy(pool_k.copy()),
                              "v": torch.from_numpy(pool_v.copy()),
                              "len": torch.zeros((u, b), dtype=torch.int32)}}}
    got, _ = serve_step_paged(params, cfg, torch.from_numpy(toks), cache,
                              torch.from_numpy(tables), torch.from_numpy(pos), kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_in_scan_int8_forward(dense):
    """The in-scan int8 forward (free tier) against JAX on its own store;
    the store has 6 int8 leaves a unit without ``w_gate``, 7 with it."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.serving.quantized import quantize_serving_params as jax_quantize
    from repro.serving.quantized import tier_intervals as jax_tier_intervals

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving import quantized

    jcfg, jparams, cfg, params = dense
    masks = IN_SCAN_TIERS["free"]
    toks = _tokens(14, (2, 9))
    want, _, _ = jax_model.forward(
        jax_quantize(jparams), jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name="free", masks=masks)))
    store = quantized.quantize_serving_params(params)
    assert len(list(quantized.qleaves(store["units"]))) == (
        7 if cfg.mlp_type == "swiglu" else 6)
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(
                               LicenseTier(name="free", masks=masks), device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_lm_loss(dense):
    jcfg, jparams, cfg, params = dense
    toks = _tokens(15, (2, 8))
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)
    jl, _ = jax_model.lm_loss(jparams, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    got, _ = model.lm_loss(params, cfg, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)


def test_int8_store_by_unit_equals_stacked_quantize(dense):
    """An int8 store built unit by unit (each unit's one-unit tree through
    ``quantize_serving_params``, the results stacked) equals
    ``quantize_serving_params`` of the stacked tree, and both equal the
    whole-leaf quantization of each stacked leaf in f32: the scale
    reduces over the contraction dim only, so ``_quantize_leaf``'s loop
    over the unit axis changes no code and no scale."""
    from repro_torch.serving import quantized

    _, _, cfg, params = dense
    want = quantized.quantize_serving_params(params)

    def unit_slice(tree, u):
        if isinstance(tree, dict):
            return {k: unit_slice(v, u) for k, v in tree.items()}
        return tree[u:u + 1]

    ones = [quantized.quantize_serving_params({"units": unit_slice(params["units"], u)})
            for u in range(cfg.pattern_units)]
    stacked = jax.tree_util.tree_map(lambda *ts: torch.cat(ts), *[o["units"] for o in ones])
    assert (jax.tree_util.tree_structure(stacked)
            == jax.tree_util.tree_structure(want["units"]))
    for g, w in zip(jax.tree_util.tree_leaves(stacked), jax.tree_util.tree_leaves(want["units"])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n = 0
    for name, leaf in _named_leaves(params["units"], "units"):
        if not quantized._eligible(name, leaf):
            continue
        w = leaf.float()
        amax = w.abs().amax(dim=-2, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        got = _at(want, name)
        assert torch.equal(got["codes"], codes) and torch.equal(got["scale"], scale)
        n += 1
    assert n == (7 if cfg.mlp_type == "swiglu" else 6)


def _named_leaves(tree, name):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{name}/{k}")
    else:
        yield name, tree


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


# --------------------------------------------------------- DeepSeek MoE/MLA
# deepseek-moe-16b (MHA attention, MoE) and deepseek-v2-lite-16b (MLA,
# MoE) at their smoke variants: 4 experts, top-2, one shared expert
DEEPSEEK = ("deepseek-moe-16b", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module", params=DEEPSEEK)
def deepseek(request):
    jcfg = jax_smoke_variant(jax_get_config(request.param))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config(request.param))
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def test_deepseek_config_fields_match_jax(deepseek):
    """Every field of the full config and its smoke variant, ``source``
    included; ``check_supported`` takes both, the recurrent family
    (mamba2-130m, recurrentgemma-2b) and the front-end stubs
    (musicgen-large, internvl2-26b), each registered by the port, and
    ``kv_cache_int8`` (which an MLA cache ignores) and a sliding window
    (MLA's latent ring since it was ported; the JAX package takes both),
    and still refuses an MLP it has not ported."""
    import dataclasses

    jcfg, _, cfg, _ = deepseek
    name = cfg.name[: -len("-smoke")]
    for got, want in ((get_config(name), jax_get_config(name)), (cfg, jcfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        model.check_supported(got)
    for ported in ("mamba2-130m", "recurrentgemma-2b", "musicgen-large", "internvl2-26b"):
        assert get_config(ported) == _port_config(ported)
        model.check_supported(get_config(ported))
    model.check_supported(get_config(name).replace(kv_cache_int8=True))
    model.check_supported(get_config(name).replace(window=4096))
    with pytest.raises(NotImplementedError, match="the other architectures"):
        model.check_supported(get_config(name).replace(mlp_type="gelu"))


def _port_config(name):
    """The JAX package's config ``name`` as the port's dataclass (the port
    registers only what it runs)."""
    import dataclasses

    from repro_torch.configs import ModelConfig

    return ModelConfig(**dataclasses.asdict(jax_get_config(name)))


def test_deepseek_one_shot_prefill(deepseek):
    jcfg, jparams, cfg, params = deepseek
    toks = _tokens(20, (2, 9))
    want, jaux, _ = jax_model.forward(jparams, jcfg, jnp.asarray(toks))
    got, aux, _ = model.forward_aux(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_deepseek_prefill_then_decode(deepseek):
    jcfg, jparams, cfg, params = deepseek
    toks, nxt, cap = _tokens(21, (2, 6)), _tokens(22, (2, 1)), 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    _, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache, pos=6)
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache, pos=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_c, want_c = cache["units"]["b0"], jcache["units"]["b0"]
    assert set(got_c) == set(want_c)
    for key in got_c:
        np.testing.assert_allclose(got_c[key].numpy(), np.asarray(want_c[key]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_deepseek_paged_decode(deepseek, route):
    """A decode step against a random pool of the config's paged leaves,
    3 live lanes and a pad lane: the plain route against JAX
    ``serve_step_paged(kernel="off")``, the kernel route against
    ``kernel="interpret"`` (the Pallas kernels for deepseek-moe-16b's
    attention, whose wrappers take the plain versions on the CPU; MLA has
    no kernel route in either package)."""
    jcfg, jparams, cfg, params = deepseek
    r = np.random.default_rng(23)
    u, bs, p = cfg.pattern_units, 4, 12
    pos = np.asarray([5, 13, 2, 0], np.int32)
    tables = np.full((4, 4), p, np.int32)
    perm = r.permutation(p)
    tables[0, :2], tables[1, :4], tables[2, :1] = perm[:2], perm[2:6], perm[6:7]
    toks = r.integers(0, 500, (4, 1)).astype(np.int32)
    lane = model.init_cache(cfg, 1, bs, device="meta")["units"]["b0"]
    leaves = {k: r.standard_normal((u, p + 1, bs, *t.shape[3:])).astype(np.float32)
              for k, t in lane.items() if k != "len"}
    jcache = {"units": {"b0": {**{k: jnp.asarray(v)[:, None] for k, v in leaves.items()},
                               "len": jnp.zeros((u, 4), jnp.int32)}}}
    want, jcache = jax_serve_step_paged(
        jparams, jcfg, jnp.asarray(toks), jcache, jnp.asarray(tables), jnp.asarray(pos),
        kernel="off" if route == "plain" else "interpret")
    cache = {"units": {"b0": {**{k: torch.from_numpy(v.copy()) for k, v in leaves.items()},
                              "len": torch.zeros((u, 4), dtype=torch.int32)}}}
    got, cache = serve_step_paged(params, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(tables), torch.from_numpy(pos),
                                  kernel=route == "kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in leaves:           # the written tokens (null block excluded)
        np.testing.assert_allclose(cache["units"]["b0"][key][:, :p].numpy(),
                                   np.asarray(jcache["units"]["b0"][key])[:, 0, :p],
                                   atol=1e-5, rtol=1e-5)
    assert cache["units"]["b0"]["len"].tolist() == [[1] * 4] * u


@pytest.mark.parametrize("tier", sorted(IN_SCAN_TIERS))
def test_deepseek_in_scan_int8_forward(deepseek, tier):
    """The in-scan int8 forward in two tiers against JAX on its own store:
    10 int8 leaves a unit (4 attention, 3 expert stacks quantized per
    (unit, expert, output channel), 3 shared), the router and
    ``ckv_norm`` left float, and bit for bit the port's forward on the
    tier's materialized view, whose expert stacks dequantize as one
    (U·E, d, ff) leaf."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.serving.quantized import quantize_serving_params as jax_quantize
    from repro.serving.quantized import tier_intervals as jax_tier_intervals

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving import quantized

    jcfg, jparams, cfg, params = deepseek
    masks = IN_SCAN_TIERS[tier]
    toks = _tokens(24, (2, 9))
    want, _, _ = jax_model.forward(
        jax_quantize(jparams), jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name=tier, masks=masks)))
    store = quantized.quantize_serving_params(params)
    units = store["units"]["b0"]
    assert len(list(quantized.qleaves(units))) == 10
    assert units["ffn"]["router"].dtype == torch.float32
    assert tuple(units["ffn"]["experts"]["w_up"]["scale"].shape) == (
        cfg.pattern_units, cfg.num_experts, 1, cfg.moe_d_ff)
    lt = LicenseTier(name=tier, masks=masks)
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(lt, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    view = quantized.materialize_licensed_view(store, lt, cfg.dtype)
    mat, _ = model.forward(view, cfg, torch.from_numpy(toks))
    assert torch.equal(got, mat)


def test_deepseek_lm_loss_includes_the_moe_aux(deepseek):
    """``lm_loss`` is the JAX package's: cross-entropy plus
    ``moe_aux_weight`` times the aux loss summed over units, and so are
    its gradients through the router, the dispatch and the experts (the
    training path's tolerance, rtol 1e-4 and atol 1e-6)."""
    from repro.core.pytree_io import flatten_params as jax_flatten

    from repro_torch.core.pytree_io import flatten_params
    from repro_torch.training.train_lib import _value_and_grad

    jcfg, jparams, cfg, params = deepseek
    toks = _tokens(25, (2, 8))
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)

    def jax_loss(p):
        return jax_model.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels))

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    (got, parts), grads = _value_and_grad(
        lambda p: model.lm_loss(p, cfg, torch.from_numpy(toks), torch.from_numpy(labels)),
        params)
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux_loss"]), float(jparts["aux_loss"]), rtol=1e-5)
    assert float(parts["aux_loss"]) > 0
    want, grads = jax_flatten(jgrads), flatten_params(grads)
    assert list(grads) == list(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
