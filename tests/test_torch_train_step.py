"""One ``make_train_step`` step of the port on every assigned
architecture, held against the JAX package's, on the CPU.

The port's counterpart of ``tests/test_arch_smoke.py::test_one_train_step``:
each arch's smoke variant (f32), the JAX ``init_params(PRNGKey(0))``
weights carried across with ``params_from_jax``, and one batch drawn with
numpy from a seed (tokens, labels with masked entries and, for
internvl2-26b, ``patch_embeds``).  Both packages take one step of their
``make_train_step`` from a fresh ``init_state`` with the optimizer
settings of ``tests/test_torch_training.py`` (Adam's eps 1e-4, warmup 1):
loss and grad norm at rtol 1e-5, the updated params at that file's
``train_loop`` tolerance (atol 1e-5) and the moments, as the clipped
gradient each carries after one step, at its gradient tolerance (rtol
1e-4, atol 1e-6).
internvl2-26b also takes the step at ``grad_accum`` 2 against the JAX
step at 2, and in bf16 on f32 patch embeddings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import make_train_step as jax_make_train_step
from repro.training import optimizer as jax_opt

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models.model import params_from_jax
from repro_torch.training import OptimizerConfig, init_state, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BATCH, SEQ = 2, 16
OCFG = dict(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=3)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)      # test_torch_training.py's gradients
CASES = [(arch, 1) for arch in ASSIGNED_ARCHS] + [("internvl2-26b", 2)]


def make_batch(cfg, seed=0):
    """tokens and labels (a few masked) drawn with numpy; ``patch_embeds``
    for a vision front end."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    labels[0, :3] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return batch


def _close(got, want, fn=lambda a: a, **tol):
    """Every leaf of two dict trees (port tensors, JAX arrays), each
    through ``fn`` first, at ``tol``."""
    want = jax_flatten_params(want)
    got = flatten_params(got)
    assert list(got) == list(want)
    for name, arr in want.items():
        np.testing.assert_allclose(fn(got[name].detach().numpy()), fn(np.asarray(arr)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("arch,grad_accum", CASES,
                         ids=[f"{a}-accum{m}" for a, m in CASES])
def test_one_train_step_matches_jax(arch, grad_accum):
    jcfg = jax_smoke_variant(jax_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(cfg)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxOptimizerConfig(grad_accum=grad_accum,
                                                                 **OCFG)))
    jnew, jstate, jm = jstep(jparams, jax_opt.init_state(jparams),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    step = make_train_step(cfg, OptimizerConfig(grad_accum=grad_accum, **OCFG))
    new, state, metrics = step(params, init_state(params),
                               {k: torch.from_numpy(v) for k, v in batch.items()})

    assert int(state.step) == int(jstate.step) == 1
    for key in ("loss", "lm_loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7 if key == "aux_loss" else 0, err_msg=key)
    assert np.isfinite(float(metrics["loss"]))
    _close(new, jnew, rtol=0, atol=1e-5)
    # one step from zero moments: m = (1 - b1) g and v = (1 - b2) g^2, g the
    # clipped gradient, so each is held as g at the gradient's tolerance
    b1, b2 = OptimizerConfig().beta1, OptimizerConfig().beta2
    _close(state.m, jstate.m, lambda a: a / (1 - b1), **GRAD_TOL)
    _close(state.v, jstate.v, lambda a: np.sqrt(a / (1 - b2)), **GRAD_TOL)


def test_bf16_vlm_step_takes_f32_patch_embeds():
    """internvl2-26b's smoke variant in bf16 on an f32 batch of patch
    embeddings (a host batch has no bf16): ``jnp.einsum`` projects them in
    the promoted f32, and so must the port.  Loss and grad norm at the
    bf16 tolerance of ``tests/test_kernels.py`` (2e-2)."""
    arch = "internvl2-26b"
    jcfg = jax_smoke_variant(jax_get_config(arch)).replace(dtype_name="bfloat16")
    cfg = smoke_variant(get_config(arch)).replace(dtype_name="bfloat16")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(cfg)
    assert batch["patch_embeds"].dtype == np.float32
    _, _, jm = jax.jit(jax_make_train_step(jcfg, JaxOptimizerConfig(**OCFG)))(
        jparams, jax_opt.init_state(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    new, _, metrics = make_train_step(cfg, OptimizerConfig(**OCFG))(
        params, init_state(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=2e-2,
                                   err_msg=key)
    assert all(t.dtype == torch.bfloat16 for t in flatten_params(new).values())
