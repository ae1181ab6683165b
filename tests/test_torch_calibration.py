"""Algorithm 1 of the port against the JAX package, on the CPU.

``calibrate_license``, ``license_stats`` and ``make_static_tiers`` run in
both packages on the same weights: the reference's ``init_params(
jax.random.PRNGKey(0), smoke_variant(cfg))`` in f32, and the same cast to
bf16 (``ml_dtypes`` bfloat16 arrays on the JAX side, carried across bit
for bit).  ``eval_fn`` is the exact survival fraction over the maskable
leaves, computed identically in both packages, so the cut intervals per
leaf, the step trace (interval, layer, accuracy) and the final accuracy
must all be IDENTICAL, in both interval modes, with and without
``refine_steps``, and with a ``layer_order``.

The quantile edges come from a count of bit patterns for 16-bit weights
and from a sort otherwise (``magnitude_quantiles``); both are held to
``np.quantile`` on the same values.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import licensing as jax_licensing
from repro.core.compression import is_dynamics_param as jax_is_dynamics_param
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params

from repro_torch.core import licensing
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models.model import params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    if request.param == "bfloat16":
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    return jparams, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _maskable(names, exclude):
    return [n for n, nd in names if not exclude(n) and nd >= 2]


def jax_survival(params):
    """Fraction of maskable weights not zero (the JAX side's ``eval_fn``)."""
    flat = jax_flatten_params(params)
    names = _maskable([(n, a.ndim) for n, a in flat.items()], jax_is_dynamics_param)
    kept = sum(int((np.asarray(flat[n]) != 0).sum()) for n in names)
    return kept / sum(flat[n].size for n in names)


def torch_survival(params):
    """The same count on the port's tensors."""
    flat = flatten_params(params)
    names = _maskable([(n, t.ndim) for n, t in flat.items()],
                      licensing.is_dynamics_param)
    kept = sum(int((flat[n] != 0).sum()) for n in names)
    return kept / sum(flat[n].numel() for n in names)


def _trace(trace):
    return [(s.interval, s.layer, s.accuracy) for s in trace]


CASES = {
    "quantile": dict(interval_mode="quantile"),
    "quantile_refine": dict(interval_mode="quantile", refine_steps=4),
    "width": dict(interval_mode="width"),
    "width_refine": dict(interval_mode="width", refine_steps=3),
    "quantile_k7_tight": dict(interval_mode="quantile", k_intervals=7, tolerance=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_calibrate_license_matches_jax(weights, case):
    jparams, params = weights
    kw = CASES[case]
    jtier, jtrace = jax_licensing.calibrate_license(jparams, jax_survival, 0.75, **kw)
    tier, trace = licensing.calibrate_license(params, torch_survival, 0.75, **kw)
    assert _trace(trace) == _trace(jtrace)
    assert tier.masks == jtier.masks
    assert tier.accuracy == jtier.accuracy
    assert tier.fingerprint() == jtier.fingerprint()
    assert len(trace) > 1 and tier.accuracy <= 0.75 + kw.get("tolerance", 0.02)


def test_calibrate_license_layer_order_and_exclude(weights):
    """A layer order (reversed, with a name that is no leaf) and an
    ``exclude`` that also spares the attention output."""
    jparams, params = weights
    names = list(flatten_params(params))
    order = ["no/such/layer"] + names[::-1]

    def spare(n):
        return licensing.is_dynamics_param(n) or n.endswith("mixer/wo")

    kw = dict(layer_order=order, refine_steps=2, k_intervals=5)
    jtier, jtrace = jax_licensing.calibrate_license(jparams, jax_survival, 0.6,
                                                    exclude=spare, **kw)
    tier, trace = licensing.calibrate_license(params, torch_survival, 0.6,
                                              exclude=spare, **kw)
    assert _trace(trace) == _trace(jtrace)
    assert tier.masks == jtier.masks and tier.accuracy == jtier.accuracy
    assert trace[0].layer == [n for n in order if n in tier.masks][0]
    assert not any(n.endswith("mixer/wo") for n in tier.masks)


def test_unreachable_target_cuts_everything(weights):
    """A target below what cutting every interval reaches: the trace
    covers every (interval, layer) and the tier every maskable layer."""
    jparams, params = weights
    jtier, jtrace = jax_licensing.calibrate_license(jparams, jax_survival, -1.0,
                                                    k_intervals=3)
    tier, trace = licensing.calibrate_license(params, torch_survival, -1.0,
                                              k_intervals=3)
    assert _trace(trace) == _trace(jtrace) and tier.masks == jtier.masks
    assert len(trace) == 3 * len(tier.masks)


def test_license_stats_matches_jax(weights):
    jparams, params = weights
    tier, _ = licensing.calibrate_license(params, torch_survival, 0.7,
                                          refine_steps=2)
    jtier = jax_licensing.LicenseTier(name=tier.name, masks=tier.masks)
    for t, jt in ((tier, jtier), (licensing.FULL_TIER, jax_licensing.FULL_TIER),
                  (licensing.LicenseTier("free", {"*": ((0.0, 0.01),)}),
                   jax_licensing.LicenseTier("free", {"*": ((0.0, 0.01),)}))):
        assert licensing.license_stats(params, t) == jax_licensing.license_stats(jparams, jt)


def test_make_static_tiers_matches_jax(weights):
    jparams, params = weights
    targets = {"gold": 0.9, "silver": 0.7, "bronze": 0.5}
    jt = jax_licensing.make_static_tiers(jparams, jax_survival, targets, k_intervals=6)
    tt = licensing.make_static_tiers(params, torch_survival, targets, k_intervals=6)
    assert list(tt) == list(jt) == ["gold", "silver", "bronze"]
    for name in targets:
        assert tt[name].masks == jt[name].masks
        assert tt[name].accuracy == jt[name].accuracy


# ------------------------------------------------------ the quantile edges
QS = [np.linspace(0.0, 1.0, 11), np.linspace(0.0, 1.0, 8), np.linspace(0.0, 1.0, 31),
      np.array([0.0, 1e-9, 0.25, 0.3333333, 0.5, 0.5 + 1e-12, 0.999999, 1.0])]


def _leaves(seed, dtype, shapes=((7, 33), (5, 4, 9), (128, 3), (1, 1))):
    """Dense normal leaves with ties, exact zeros and -0.0."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape) * (0.02 if i % 2 else 3.0)
        a.reshape(-1)[:: 11] = 0.0
        a.reshape(-1)[1:: 13] = -0.0
        a.reshape(-1)[2:: 5] = a.reshape(-1)[3:: 5][: len(a.reshape(-1)[2:: 5])]
        out.append(a.astype(dtype))
    return out


def _sparse_leaves(seed, dtype):
    """A few magnitudes spread over many binades: neighbours whose
    difference does not fit the dtype, and interpolation weights on both
    sides of 0.5 whose two lerp forms differ in float64."""
    rng = np.random.default_rng(seed)
    mags = np.exp2(rng.uniform(-12, 12, 23)) * rng.choice([-1, 1], 23)
    return [mags[:9].reshape(3, 3).astype(dtype), mags[9:].reshape(2, 7).astype(dtype)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("data", ["dense0", "dense1", "dense2", "sparse3", "sparse4"])
def test_magnitude_quantiles_equal_np_quantile(dtype, data):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    make = _sparse_leaves if data.startswith("sparse") else _leaves
    arrays = make(int(data[-1]), np_dtype)
    tensors = [torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
               if dtype == "bfloat16" else torch.from_numpy(a.copy()) for a in arrays]
    mags = np.concatenate([np.abs(a).reshape(-1) for a in arrays])
    for qs in QS:
        want = np.quantile(mags, qs)
        got = licensing.magnitude_quantiles(tensors, qs)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_magnitude_quantiles_refuses_mixed_dtypes():
    with pytest.raises(TypeError, match="one dtype"):
        licensing.magnitude_quantiles([torch.ones(2, 2), torch.ones(2, 2).bfloat16()],
                                      QS[0])
