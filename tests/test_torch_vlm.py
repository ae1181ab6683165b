"""internvl2-26b (the vision front-end stub) in the port, against the JAX
package, on the CPU.

The smoke variant (GQA 4/4 after ``smoke_variant``'s cut, 8 patches): a
``forward`` whose input is the projected patch embeddings (``vision_proj``)
prepended to the text tokens, and the patches alone; ``lm_loss``, which
drops the patch positions' logits before the loss, with its gradients
(``vision_proj`` included); ``engine.prefill_step(patch_embeds=)`` then a
decode step after the prefix; ``vision_proj`` kept float in the int8
store; and the gateway's greedy tokens per tier on float and int8 views
(the gateway serves text, as the JAX one does).

Norm scales carry numpy noise (``test_torch_layernorm.noisy_norms``);
patch embeddings come from numpy seeds.  f32 logits at atol = rtol = 1e-4
(``test_torch_model.py``), gradients at rtol 1e-4 and atol 1e-6.
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
from repro.serving import engine as jax_engine
from repro.serving.quantized import quantize_serving_params as jax_quantize

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import model
from repro_torch.serving import engine, quantized
from repro_torch.training.train_lib import _value_and_grad
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_layernorm import gateway_streams, launcher_matches_jax, noisy_norms

TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "internvl2-26b"


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_smoke_variant(jax_get_config(NAME))
    jparams, flat = noisy_norms(jax_init_params(jax.random.PRNGKey(0), jcfg), seed=1)
    cfg = smoke_variant(get_config(NAME))
    return jcfg, jparams, cfg, model.params_from_jax(flat, device="cpu")


def _inputs(cfg, seed, b=2, s=6):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    patches = r.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


def test_config_and_vision_proj(vlm):
    jcfg, _, cfg, params = vlm
    for got, want in ((get_config(NAME), jax_get_config(NAME)), (cfg, jcfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        model.check_supported(got)
    assert cfg.frontend == "vision" and cfg.num_patches == 8
    assert tuple(params["vision_proj"].shape) == (cfg.d_model, cfg.d_model)
    own = model.init_params(cfg, seed=0, device="cpu")
    assert ({n: tuple(t.shape) for n, t in flatten_params(own).items()}
            == {n: tuple(t.shape) for n, t in flatten_params(params).items()})
    std = float(own["vision_proj"].std())
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.05      # normal / sqrt(fan_in)


def test_forward_with_patch_prefix(vlm):
    """Text after the patch prefix, and the patches alone (no tokens)."""
    jcfg, jparams, cfg, params = vlm
    toks, patches = _inputs(cfg, 2)
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                                   patch_embeds=jnp.asarray(patches))
    got, _ = model.forward(params, cfg, torch.from_numpy(toks),
                           patch_embeds=torch.from_numpy(patches))
    assert tuple(got.shape) == (2, cfg.num_patches + 6, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _, _ = jax_model.forward(jparams, jcfg, None, patch_embeds=jnp.asarray(patches))
    got, _ = model.forward(params, cfg, None, patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_loss_slices_patches_and_grads(vlm):
    """Labels cover the text; the loss and every gradient, ``vision_proj``
    among them, equal the JAX package's, and the loss differs from the
    loss over the text alone (the prefix is attended)."""
    jcfg, jparams, cfg, params = vlm
    toks, patches = _inputs(cfg, 3, s=8)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)

    def jax_loss(p):
        return jax_model.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                                 patch_embeds=jnp.asarray(patches))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    (got, _), grads = _value_and_grad(
        lambda p: model.lm_loss(p, cfg, torch.from_numpy(toks), torch.from_numpy(labels),
                                patch_embeds=torch.from_numpy(patches)), params)
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    text_only, _ = model.lm_loss(params, cfg, torch.from_numpy(toks), torch.from_numpy(labels))
    assert float(text_only) != float(got)
    want, grads = jax_flatten_params(jgrads), flatten_params(grads)
    assert list(grads) == list(want) and float(grads["vision_proj"].abs().max()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_prefill_step_with_patches_then_decode(vlm):
    """``prefill_step(patch_embeds=)`` fills positions 0..P+S-1; a decode
    step at P+S reads them."""
    jcfg, jparams, cfg, params = vlm
    toks, patches = _inputs(cfg, 4)
    n, cap = cfg.num_patches + toks.shape[1], cfg.num_patches + 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    want, jcache = jax_engine.prefill_step(jparams, jcfg, jnp.asarray(toks), jcache,
                                           patch_embeds=jnp.asarray(patches))
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    got, cache = engine.prefill_step(params, cfg, torch.from_numpy(toks), cache,
                                     patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["units"]["b0"]["len"].tolist() == [[n, n]] * cfg.pattern_units
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache, pos=n)
    got, _ = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache, pos=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_store_keeps_vision_proj_float(vlm):
    """``vision_proj`` lies outside ``units/`` and ``tail/``: float in both
    packages' int8 stores; the in-scan forward with patches matches."""
    jcfg, jparams, cfg, params = vlm
    store, jstore = quantized.quantize_serving_params(params), jax_quantize(jparams)
    assert isinstance(store["vision_proj"], torch.Tensor)
    assert not isinstance(jstore["vision_proj"], dict)
    assert torch.equal(store["vision_proj"], params["vision_proj"])
    toks, patches = _inputs(cfg, 6)
    want, _, _ = jax_model.forward(jstore, jcfg, jnp.asarray(toks),
                                   patch_embeds=jnp.asarray(patches))
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_gateway_tokens_match_jax(vlm, mode):
    jreqs, reqs, jgw, gw = gateway_streams(*vlm, mode)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert list(gw.trace) == list(jgw.trace)
    assert gw.stats["preempted"] == jgw.stats["preempted"] > 0


def test_launcher_matches_jax(tmp_path, capsys):
    """``--arch internvl2-26b`` serves text through both launchers."""
    launcher_matches_jax(NAME, tmp_path, capsys)
