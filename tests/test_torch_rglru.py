"""The port's RG-LRU block (``repro_torch.models.rglru``) and the
recurrentgemma-2b model, tail blocks included, against the JAX package,
on the CPU.

The smoke variant has 3 layers (one (rec, rec, attn) unit, no tail), so
the model cases take a 5-layer variant: one unit and the two rank-2
tail blocks ``tail/t0``, ``tail/t1``.  Weights are the JAX package's
``init_params(PRNGKey(0), ...)`` carried across with ``params_from_jax``;
inputs come from numpy seeds.  Tolerances: the scan at atol = rtol =
1e-5 in f32 (the port's doubling scan and ``lax.associative_scan``
combine the same pairs in different trees; observed ~1e-6), logits and
caches at atol = rtol = 1e-4 as in ``test_torch_model.py``, greedy
tokens exact, gradients at rtol 1e-4 and atol 1e-5: the training path's
atol of 1e-6 is met by all but ~20 of 131,072 embedding entries, whose
gradients pass back through 12 positions of the two scans' different
summation trees (observed 2.8e-6).
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
from repro.models import rglru as jax_rglru

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import model, rglru
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
LAYERS = 5          # one (rec, rec, attn) unit and a (rec, rec) tail


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("recurrentgemma-2b")).replace(num_layers=LAYERS)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("recurrentgemma-2b")).replace(num_layers=LAYERS)
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 500, shape, dtype=np.int32)


def test_config_and_tail(weights):
    jcfg, _, cfg, _ = weights
    full = get_config("recurrentgemma-2b")
    assert full == model.ModelConfig(**__import__("dataclasses").asdict(
        jax_get_config("recurrentgemma-2b")))
    assert (full.pattern_units, full.tail_pattern, full.window) == (8, ("rec", "rec"), 2048)
    assert (cfg.pattern_units, cfg.tail_pattern) == (jcfg.pattern_units, jcfg.tail_pattern) \
        == (1, ("rec", "rec"))


def test_a_param_is_the_jax_packages(weights):
    """The same lambda in both packages, from ``default_rng(42)``, every
    unit and tail block."""
    _, jparams, cfg, _ = weights
    want = np.asarray(jparams["tail"]["t0"]["mixer"]["a_param"])
    np.testing.assert_array_equal(rglru.a_param_init(cfg.lru_width), want)
    got = flatten_params(model.init_params(cfg, seed=3, device="cpu"))
    for name, t in got.items():
        if name.endswith("a_param"):
            np.testing.assert_array_equal(t.reshape(-1, cfg.lru_width).numpy()[0], want)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [1, 7, 64])
def test_rglru_scan_matches_associative_scan(length, with_state):
    b, w = 2, 6
    u = _rand(0, (b, length, w))
    r = 1 / (1 + np.exp(-_rand(1, (b, length, w))))
    i = 1 / (1 + np.exp(-_rand(2, (b, length, w))))
    a_param = rglru.a_param_init(w)
    h0 = _rand(3, (b, w)) if with_state else None
    want_h, want_last = jax_rglru._rglru_scan(
        *(jnp.asarray(t.astype(np.float32)) for t in (u, r, i, a_param)),
        None if h0 is None else jnp.asarray(h0))
    got_h, got_last = rglru._rglru_scan(
        *(torch.from_numpy(t.astype(np.float32)) for t in (u, r, i, a_param)),
        None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **SCAN_TOL)


def _block(weights, where=("units", "b0")):
    jcfg, jparams, cfg, params = weights
    jp, tp = jparams[where[0]][where[1]]["mixer"], params[where[0]][where[1]]["mixer"]
    if where[0] == "units":
        jp = jax.tree_util.tree_map(lambda t: t[0], jp)
        tp = {k: v[0] for k, v in tp.items()}
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("where", [("units", "b1"), ("tail", "t1")])
def test_rglru_block_prefill_then_decode(weights, where):
    """No cache; then a cache from non-zero state: a 9-token prefill and
    three single steps, outputs and the conv and f32 state each step."""
    jcfg, jp, cfg, tp = _block(weights, where)
    x = _rand(4, (2, 11, cfg.d_model), 0.5)
    want, _ = jax_rglru.rglru_block(jp, jnp.asarray(x), jcfg)
    got, _ = rglru.rglru_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = jax_rglru.init_rglru_cache(jcfg, 2, jnp.float32)
    assert {k: tuple(v.shape) for k, v in rglru.init_rglru_cache(
        cfg, (2,), torch.float32, "cpu").items()} == {k: v.shape for k, v in jc.items()}
    init = {"conv": _rand(5, jc["conv"].shape, 0.3), "state": _rand(6, jc["state"].shape, 0.3)}
    jcache = {k: jnp.asarray(v) for k, v in init.items()}
    cache = {k: torch.from_numpy(v) for k, v in init.items()}
    for step, length in enumerate((9, 1, 1, 1)):
        x = _rand(7 + step, (2, length, cfg.d_model), 0.5)
        want, jcache = jax_rglru.rglru_block(jp, jnp.asarray(x), jcfg, cache=jcache)
        got, cache = rglru.rglru_block(tp, torch.from_numpy(x), cfg, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **TOL)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu``'s default is the tanh approximation; torch's is erf."""
    x = np.linspace(-6, 6, 97).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(torch.nn.functional.gelu(torch.from_numpy(x),
                                                        approximate="tanh").numpy(),
                               want, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_model_prefill_and_decode_past_the_window(weights):
    """A 40-token prefill into caches of capacity 48 (the ring: window 32,
    so the prefill holds more tokens than the ring has slots), then 8
    greedy steps fed back: logits, tokens and every cache leaf, the tail
    blocks' included."""
    jcfg, jparams, cfg, params = weights
    toks = _tokens(10, (2, 40))
    jcache = jax_model.init_cache(jcfg, 2, 48)
    cache = model.init_cache(cfg, 2, 48, device="cpu")
    want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    got, cache = model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for step in range(8):
        want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache,
                                            pos=40 + step)
        got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache,
                                   pos=40 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want)[:, -1].argmax(-1)
        assert got[:, -1].argmax(-1).tolist() == tok.tolist()
        nxt = tok.astype(np.int32)[:, None]
    want_c, got_c = jax_flatten_params(jcache), flatten_params(cache)
    assert list(got_c) == list(want_c)
    assert tuple(got_c["units/b2/k"].shape)[2] == cfg.window
    assert tuple(got_c["tail/t0/state"].shape) == (2, cfg.lru_width)
    for name, t in got_c.items():
        np.testing.assert_allclose(t.float().numpy(), np.asarray(want_c[name], np.float32),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("tier", ["free", "banded"])
def test_in_scan_int8_forward_with_tail(weights, tier):
    """The int8 store dequantized inside the step, the rank-2 tail leaves
    included (23 int8 leaves a unit, 8 a tail block, scale (1, C) on the
    tail), against the JAX store's forward; bit for bit against the
    port's forward on the tier's materialized view."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.serving.quantized import quantize_serving_params as jax_quantize
    from repro.serving.quantized import tier_intervals as jax_tier_intervals

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving import quantized

    jcfg, jparams, cfg, params = weights
    masks = {"free": {"*": ((0.0, 0.01),)},
             "banded": {"*": ((0.0, 0.004), (0.02, 0.03))}}[tier]
    toks = _tokens(11, (2, 9))
    jstore = jax_quantize(jparams)
    want, _, _ = jax_model.forward(
        jstore, jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name=tier, masks=masks)))
    store = quantized.quantize_serving_params(params)
    assert sum(1 for _ in quantized.qleaves(store["units"])) == 23
    assert [sum(1 for _ in quantized.qleaves(b)) for b in store["tail"].values()] == [8, 8]
    w_r = store["tail"]["t0"]["mixer"]["w_r"]
    assert tuple(w_r["scale"].shape) == (1, cfg.lru_width) and w_r["codes"].ndim == 2
    np.testing.assert_array_equal(w_r["codes"].numpy(),
                                  np.asarray(jstore["tail"]["t0"]["mixer"]["w_r"]["codes"]))
    lt = LicenseTier(name=tier, masks=masks)
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(lt, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    view = quantized.materialize_licensed_view(store, lt, cfg.dtype)
    mat, _ = model.forward(view, cfg, torch.from_numpy(toks))
    assert torch.equal(got, mat)


def test_float_view_masks_what_jax_masks(weights):
    """``apply_license`` on the float weights leaves the dynamics
    (``a_param``, norms) as the JAX package does, tail blocks included."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.core.licensing import apply_license as jax_apply_license

    from repro_torch.core.licensing import LicenseTier, apply_license

    _, jparams, _, params = weights
    masks = {"*": ((0.0, 0.05),)}
    want = jax_flatten_params(jax_apply_license(jparams, JaxLicenseTier(name="t", masks=masks)))
    got = flatten_params(apply_license(params, LicenseTier(name="t", masks=masks)))
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)
    assert got["tail/t0/mixer/a_param"] is params["tail"]["t0"]["mixer"]["a_param"]


def test_lm_loss_and_grads_match_jax(weights):
    from repro_torch.training.train_lib import _value_and_grad

    jcfg, jparams, cfg, params = weights
    toks = _tokens(12, (2, 12))
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels)),
        has_aux=True))(jparams)
    (got, _), grads = _value_and_grad(
        lambda p: model.lm_loss(p, cfg, torch.from_numpy(toks), torch.from_numpy(labels)),
        params)
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    want, grads = jax_flatten_params(jgrads), flatten_params(grads)
    assert list(grads) == list(want)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
