"""Licensing math of the port against the JAX package, on the same weights.

Masks, int8 codes and scales are integer or select-only results, so
everything here must match EXACTLY: layer names and their order, masked
views at f32 and bf16, tier fingerprints, quantized codes and scales
(``torch.round`` and ``jnp.round`` both round half to even) and the
materialized int8 views.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import licensing as jax_licensing
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import quantized as jax_quantized

from repro_torch.core import licensing
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models.model import params_from_jax
from repro_torch.serving import quantized
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TIERS = {
    "free": {"*": ((0.0, 0.01),)},
    # per-layer patterns: apply_license honours them, the int8 path merges
    # every pattern's intervals into one global set (copied as is)
    "mixed": {"mixer/wq": ((0.0, 0.02),), "ffn": ((0.01, 0.03), (0.05, 0.06))},
}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    cfg = jax_smoke_variant(jax_get_config("qwen2.5-3b")).replace(
        dtype_name=request.param)
    jparams = jax_init_params(jax.random.PRNGKey(0), cfg)
    return jparams, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_trees_equal(jtree, ttree):
    jflat = jax_flatten_params(jtree)
    tflat = flatten_params(ttree)
    assert list(tflat) == list(jflat)
    for name, arr in jflat.items():
        np.testing.assert_array_equal(_np(tflat[name]), np.asarray(arr, np.float32)
                                      if arr.dtype == jnp.bfloat16 else arr, err_msg=name)


def test_flatten_names_and_order(weights):
    jparams, params = weights
    jflat = jax_flatten_params(jparams)
    flat = flatten_params(params)
    assert list(flat) == list(jflat)
    assert [tuple(t.shape) for t in flat.values()] == \
        [tuple(a.shape) for a in jflat.values()]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_apply_license_identical(weights, tier):
    jparams, params = weights
    jt = jax_licensing.LicenseTier(name=tier, masks=TIERS[tier])
    tt = licensing.LicenseTier(name=tier, masks=TIERS[tier])
    assert tt.fingerprint() == jt.fingerprint()
    _assert_trees_equal(jax_licensing.apply_license(jparams, jt),
                        licensing.apply_license(params, tt))


def test_bf16_bounds_compare_in_weight_dtype():
    """0.0302 rounds DOWN to 0.030151367 in bf16, so a bf16 weight of
    exactly that value is inside [0.0302, 0.05) for JAX's weak-typed
    compare — an f32 compare would let it survive."""
    vals = np.asarray([[0.030151367, 0.0302, -0.04, 0.05, 0.0299, 0.07]], np.float32)
    want = jax_licensing.mask_weight(jnp.asarray(vals, jnp.bfloat16), [(0.0302, 0.05)])
    got = licensing.mask_weight(torch.from_numpy(vals).bfloat16(), [(0.0302, 0.05)])
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert got[0, 0] == 0


def test_quantized_store_identical(weights):
    jparams, params = weights
    _assert_trees_equal(jax_quantized.quantize_serving_params(jparams),
                        quantized.quantize_serving_params(params))


def _assert_trees_bit_equal(jtree, ttree):
    """Leaf by leaf on the bit patterns (+0.0 and -0.0 differ)."""
    jflat = jax_flatten_params(jtree)
    tflat = flatten_params(ttree)
    assert list(tflat) == list(jflat)
    for name, arr in jflat.items():
        t = tflat[name]
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[t.element_size()]
        np.testing.assert_array_equal(t.view(bits[0]).numpy(),
                                      np.asarray(arr).view(bits[1]), err_msg=name)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", sorted(TIERS) + ["full"])
def test_materialized_int8_view_identical(weights, tier, out_dtype):
    """The port's view (one masked-dequant call per stacked leaf) against
    the JAX package's (slice by slice, then stacked), bit for bit."""
    jparams, params = weights
    masks = TIERS.get(tier, {})
    jt = jax_licensing.LicenseTier(name=tier, masks=masks)
    tt = licensing.LicenseTier(name=tier, masks=masks)
    li, jli = quantized.tier_intervals(tt, device="cpu"), jax_quantized.tier_intervals(jt)
    assert (li is None) == (jli is None)
    if li is not None:
        for a, b in zip(li, jli):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jview = jax_quantized.materialize_licensed_view(
        jax_quantized.quantize_serving_params(jparams), jt, getattr(jnp, out_dtype))
    view = quantized.materialize_licensed_view(
        quantized.quantize_serving_params(params), tt, getattr(torch, out_dtype))
    _assert_trees_bit_equal(jview, view)
