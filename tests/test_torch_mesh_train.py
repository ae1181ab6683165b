"""The port's sharded training step on a gloo world of 4 ranks, on the
CPU: the step the JAX dry run compiles (``make_train_step`` with
``grad_accum`` 4 and AdamW, the moments ZeRO-1-placed), run on real
tensors.

``_mesh_train_worker.run`` on 4 spawned ranks over a ``FileStore``, one
torch thread each, one world per arch (``_gloo_world``: one world at a
time across pytest's workers, each rank's exit code and log tail in the
error of a world that fails): the smoke variants of qwen2.5-3b, deepseek-moe-16b,
musicgen-large and internvl2-26b in f32, with the JAX package's
``init_params(PRNGKey(0))`` weights, take two steps of 8 rows x 16 tokens
(internvl2-26b's rows with ``patch_embeds``) on a (2, 2) and a (1, 4)
mesh.  Each is held to the same two steps of the unsharded port: losses
and grad norms at rtol 1e-5, params at ``tests/test_torch_training.py``'s
``train_loop`` tolerance (atol 1e-5) and the moments, as the sums of
clipped gradients they hold, at its gradient tolerance (rtol 1e-4, atol
1e-6).
After each step every param keeps its param placements and every moment
its ZeRO-1 placements.  qwen2.5-3b is also held against the JAX
``make_train_step``'s two steps at ``train_loop``'s tolerances (losses at
rtol 1e-4, params at atol 1e-5).
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
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import make_train_step as jax_make_train_step
from repro.training import optimizer as jax_opt

import _mesh_train_worker as W
from _gloo_world import run_world, shared_dir
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import model as model_lib
from repro_torch.training import OptimizerConfig, init_state, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# a world's deadline, counted from when it holds the lock: the slowest of
# the four per-arch worlds ran at most 105.6 s with the whole suite on six
# xdist workers (``-n 6 --dist loadfile``, a busy host) and 67.5 s under
# the README's stress command; 300 s is 2.8 times that
SPAWN_TIMEOUT_S = 300
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)      # test_torch_training.py's gradients
CASES = [(arch, mesh) for arch in W.ARCHS for mesh in W.MESHES]
IDS = [f"{a}-{m}" for a, m in CASES]


def _jax_params(arch):
    return jax_init_params(jax.random.PRNGKey(0), jax_smoke_variant(jax_get_config(arch)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(arch)``: write the arch's JAX weights, run its 4-rank world
    (one world per arch, one world at a time across pytest's workers),
    return its ``out.npz`` and {arch: the port's params on the CPU}."""
    cache = {}

    def get(arch):
        if arch not in cache:
            d = tmp_path_factory.mktemp(f"mesh_train_{arch}")
            flat = {k: np.asarray(v) for k, v in jax_flatten_params(_jax_params(arch)).items()}
            np.savez(d / f"{arch}.npz", **flat)
            run_world(W.run, 4, d, SPAWN_TIMEOUT_S, shared_dir(tmp_path_factory),
                      args=((arch,),), name=f"mesh_train/{arch}")
            cache[arch] = (dict(np.load(d / "out.npz")),
                           {arch: model_lib.params_from_jax(flat, device="cpu")})
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def plain():
    """Per arch, the unsharded port's two steps on the worker's batches:
    (metrics {loss, grad_norm}, params, state)."""
    cache = {}

    def run(arch, params):
        if arch not in cache:
            cfg = W.config(arch)
            step = make_train_step(cfg, OptimizerConfig(**W.OCFG))
            p, state = params, init_state(params)
            metrics = {"loss": [], "grad_norm": []}
            for b in W.batches(cfg):
                p, state, m = step(p, state, {k: torch.from_numpy(v) for k, v in b.items()})
                for k in metrics:
                    metrics[k].append(float(m[k]))
            cache[arch] = (metrics, p, state)
        return cache[arch]

    return run


def _close(out, prefix, tree, fn=lambda a: a, **tol):
    """Every leaf of ``tree`` against the world's ``prefix/<name>``, each
    through ``fn`` first, at ``tol``."""
    for name, leaf in flatten_params(tree).items():
        np.testing.assert_allclose(fn(out[f"{prefix}/{name}"]), fn(leaf.detach().numpy()),
                                   err_msg=f"{prefix}/{name}", **tol)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sharded_train_step_matches_plain(world, plain, arch, mesh):
    out, params = world(arch)
    metrics, p, state = plain(arch, params[arch])
    key = f"{arch}/{mesh}"
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[f"{key}/{k}"], metrics[k], rtol=1e-5, err_msg=k)
    _close(out, f"{key}/params", p, rtol=0, atol=1e-5)
    # the moments in gradient units: m / (1 - b1) = b1 g1 + g2 and
    # sqrt(v / (1 - b2)) = sqrt(b2 g1^2 + g2^2), g the clipped gradients
    b1, b2 = OptimizerConfig().beta1, OptimizerConfig().beta2
    _close(out, f"{key}/m", state.m, lambda a: a / (1 - b1), **GRAD_TOL)
    _close(out, f"{key}/v", state.v, lambda a: np.sqrt(a / (1 - b2)), **GRAD_TOL)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sharded_train_step_keeps_placements(world, arch, mesh):
    out, _ = world(arch)
    key = f"{arch}/{mesh}"
    assert out[f"{key}/moved"].tolist() == []
    assert int(out[f"{key}/step"]) == W.STEPS


@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_sharded_qwen_train_step_matches_jax(world, mesh):
    arch = "qwen2.5-3b"
    out, _ = world(arch)
    jcfg = jax_smoke_variant(jax_get_config(arch))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxOptimizerConfig(**W.OCFG)))
    jp = _jax_params(arch)
    jstate = jax_opt.init_state(jp)
    losses = []
    for b in W.batches(W.config(arch)):
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v.astype(np.int32))
                                            for k, v in b.items()})
        losses.append(float(jm["loss"]))
    np.testing.assert_allclose(out[f"{arch}/{mesh}/loss"], losses, rtol=1e-4)
    for name, arr in jax_flatten_params(jp).items():
        np.testing.assert_allclose(out[f"{arch}/{mesh}/params/{name}"], np.asarray(arr),
                                   rtol=0, atol=1e-5, err_msg=name)
