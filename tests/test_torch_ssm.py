"""The port's Mamba-2 block (``repro_torch.models.ssm``) and the
mamba2-130m model against the JAX package, on the CPU.

Inputs come from numpy seeds; model weights are the JAX package's
``init_params(PRNGKey(0), smoke mamba2-130m)`` carried across with
``params_from_jax``.  Tolerances: the chunk scan and its pieces at atol =
rtol = 1e-5 in f32 (both frameworks sum the einsums in their own order;
observed ~1e-6), logits at atol = rtol = 1e-4 as in
``test_torch_model.py``, greedy tokens exact, and ``lm_loss``'s
gradients at the training path's rtol 1e-4, atol 1e-6.
"""
import dataclasses

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
from repro.models import ssm as jax_ssm

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import model, ssm
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("mamba2-130m"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("mamba2-130m"))
    return jcfg, jparams, cfg, model.params_from_jax(jax_flatten_params(jparams), device="cpu")


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 500, shape, dtype=np.int32)


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def test_config_and_widths_match_jax(weights):
    jcfg, _, cfg, _ = weights
    full, jfull = get_config("mamba2-130m"), jax_get_config("mamba2-130m")
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for c, jc in ((cfg, jcfg), (full, jfull)):
        assert (ssm.d_inner(c), ssm.n_heads(c), ssm.conv_dim(c)) == \
            (jax_ssm.d_inner(jc), jax_ssm.n_heads(jc), jax_ssm.conv_dim(jc))
    assert (ssm.d_inner(full), ssm.n_heads(full), full.padded_vocab) == (1536, 24, 50432)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length,chunk", [(32, 8), (16, 16), (8, 1)])
def test_ssd_chunked_matches_jax(length, chunk, with_state):
    b, h, p, n = 2, 3, 4, 5
    x, dt_raw = _rand(0, (b, length, h, p)), _rand(1, (b, length, h))
    bm, cm = _rand(2, (b, length, n)), _rand(3, (b, length, n))
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    s0 = _rand(4, (b, h, n, p)) if with_state else None
    want_y, want_s = jax_ssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)), chunk,
                                         None if s0 is None else jnp.asarray(s0))
    got_y, got_s = ssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), chunk,
                                   None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SCAN_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w, bias = _rand(5, (2, 7, 6)), _rand(6, (4, 6)), _rand(7, (6,))
    st = _rand(8, (2, 3, 6)) if with_state else None
    want, want_st = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                         None if st is None else jnp.asarray(st))
    got, got_st = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(bias),
                                  None if st is None else torch.from_numpy(st))
    # JAX applies the SiLU inside its conv; the port's block applies it after
    np.testing.assert_allclose(torch.nn.functional.silu(got).numpy(), np.asarray(want),
                               **SCAN_TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **SCAN_TOL)


def test_softplus_is_jaxs():
    x = np.linspace(-40, 60, 101).astype(np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6)


def _block(weights, u=0):
    jcfg, jparams, cfg, params = weights
    jp = jax.tree_util.tree_map(lambda t: t[u], jparams["units"]["b0"]["mixer"])
    tp = {k: v[u] for k, v in params["units"]["b0"]["mixer"].items()}
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("length", [16, 21, 1])
def test_ssm_block_prefill_pads_to_a_chunk_multiple(weights, length):
    """No cache: lengths a multiple of ``ssm_chunk`` (16), padded to one
    (21), and a single token (the scan, not the recurrence)."""
    jcfg, jp, cfg, tp = _block(weights)
    x = _rand(9, (2, length, cfg.d_model), 0.5)
    want, _ = jax_ssm.ssm_block(jp, jnp.asarray(x), jcfg)
    got, _ = ssm.ssm_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_block_prefill_from_state_then_decode(weights):
    """A prefill from a non-zero cache (``init_state`` and the conv
    state), then three single-step decodes: outputs and the cache's
    conv and f32 state after every step."""
    jcfg, jp, cfg, tp = _block(weights, u=1)
    jc = jax_ssm.init_ssm_cache(jcfg, 2, jnp.float32)
    init = {"conv": _rand(10, jc["conv"].shape, 0.3), "state": _rand(11, jc["state"].shape, 0.3)}
    jcache = {k: jnp.asarray(v) for k, v in init.items()}
    cache = {k: torch.from_numpy(v) for k, v in init.items()}
    assert {k: tuple(v.shape) for k, v in ssm.init_ssm_cache(
        cfg, (2,), torch.float32, "cpu").items()} == {k: v.shape for k, v in jc.items()}
    for i, length in enumerate((13, 1, 1, 1)):
        x = _rand(12 + i, (2, length, cfg.d_model), 0.5)
        want, jcache = jax_ssm.ssm_block(jp, jnp.asarray(x), jcfg, cache=jcache)
        got, cache = ssm.ssm_block(tp, torch.from_numpy(x), cfg, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **TOL)
        assert cache["state"].dtype == torch.float32


def test_model_prefill_and_decode_greedy(weights):
    """The model with a cache: a 20-token prefill (padded to 32 inside
    the scan), then 6 greedy decode steps fed back; logits, tokens and
    every cache leaf against the JAX package's."""
    jcfg, jparams, cfg, params = weights
    toks = _tokens(20, (2, 20))
    jcache = jax_model.init_cache(jcfg, 2, 32)
    cache = model.init_cache(cfg, 2, 32, device="cpu")
    want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    got, cache = model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for step in range(6):
        want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache,
                                            pos=20 + step)
        got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache,
                                   pos=20 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want)[:, -1].argmax(-1)
        assert got[:, -1].argmax(-1).tolist() == tok.tolist()
        nxt = tok.astype(np.int32)[:, None]
    want_c, got_c = _np(jax_flatten_params(jcache)), flatten_params(cache)
    assert list(got_c) == list(want_c)
    for name, t in got_c.items():
        np.testing.assert_allclose(t.numpy(), want_c[name], **TOL, err_msg=name)


def test_init_params_shapes_and_dynamics(weights):
    """``init_params`` draws its own values, with the JAX package's
    names, shapes and dtypes (bf16 matrices, f32 dynamics in a bf16
    model) and its deterministic leaves (A_log, dt_bias, D_skip, the conv
    bias, the gate norm)."""
    jcfg, jparams, cfg, _ = weights
    want = jax_flatten_params(jparams)
    got = flatten_params(model.init_params(cfg, seed=0, device="cpu"))
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert t.dtype == torch.float32, name
    for name in ("units/b0/mixer/A_log", "units/b0/mixer/dt_bias", "units/b0/mixer/D_skip",
                 "units/b0/mixer/conv_b", "units/b0/mixer/gate_norm"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6)
    bf16 = flatten_params(model.init_params(cfg.replace(dtype_name="bfloat16"), seed=0,
                                            device="cpu"))
    for name, t in bf16.items():
        f32 = name.rsplit("/", 1)[-1] in ("A_log", "dt_bias", "D_skip")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


def test_in_scan_int8_forward(weights):
    """The int8 store in a masking tier, dequantized inside the step: 2
    int8 leaves a unit (in_proj, out_proj; the conv, norms and dynamics
    stay float), against the JAX store's forward."""
    from repro.core.licensing import LicenseTier as JaxLicenseTier
    from repro.serving.quantized import quantize_serving_params as jax_quantize
    from repro.serving.quantized import tier_intervals as jax_tier_intervals

    from repro_torch.core.licensing import LicenseTier
    from repro_torch.serving import quantized

    jcfg, jparams, cfg, params = weights
    masks = {"*": ((0.0, 0.01),)}
    toks = _tokens(21, (2, 11))
    want, _, _ = jax_model.forward(
        jax_quantize(jparams), jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name="free", masks=masks)))
    store = quantized.quantize_serving_params(params)
    assert [n for n, _ in _qnames(store)] == ["units/b0/mixer/in_proj", "units/b0/mixer/out_proj"]
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(
                               LicenseTier(name="free", masks=masks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _qnames(tree, prefix=""):
    from repro_torch.serving.quantized import is_qleaf

    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if is_qleaf(v):
            yield name, v
        elif isinstance(v, dict):
            yield from _qnames(v, name)


def test_lm_loss_and_grads_match_jax(weights):
    from repro_torch.training.train_lib import _value_and_grad

    jcfg, jparams, cfg, params = weights
    toks = _tokens(22, (2, 12))
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
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
