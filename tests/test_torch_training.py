"""The port's training path against the JAX package, on the CPU.

* The paper's MLP (``TABLE1_A``, ``TABLE1_B``): ``train_mlp`` (100 steps)
  and ``finetune_pruned_mlp`` (50 steps) from the same JAX-made initial
  weights, on the same ``np.random.default_rng`` batches: params at atol
  1e-4, test accuracy within 2 / len(test set), pruned zeros exactly 0.
* The LM (smoke qwen2.5-3b, f32, one module-scoped JAX run):
  ``lm_loss`` at rtol 1e-5, every gradient leaf against ``jax.grad`` at
  rtol 1e-4 / atol 1e-6; ``apply_updates`` from one ``AdamWState`` (with
  and without decay, the clip active) at rtol 1e-5; 3 ``train_loop``
  steps with ``grad_accum`` 1 and 2 (Adam's eps 1e-4, see ``OCFG``):
  losses at rtol 1e-4, params at atol 1e-5; checkpointed every step into
  a ``WeightStore``: the same history messages, parents and chunk pages,
  weight rows within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.paper_mlp import TABLE1_A as JAX_TABLE1_A
from repro.configs.paper_mlp import TABLE1_B as JAX_TABLE1_B
from repro.core.compression import prune_params as jax_prune_params
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.data import LMDataConfig as JaxLMDataConfig
from repro.data import classification_data as jax_classification_data
from repro.data import lm_batches as jax_lm_batches
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.training import finetune_pruned_mlp as jax_finetune_pruned_mlp
from repro.training import mlp_accuracy as jax_mlp_accuracy
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train_loop
from repro.training import train_mlp as jax_train_mlp
from repro.training.train_lib import init_mlp_params as jax_init_mlp_params

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.paper_mlp import TABLE1_A, TABLE1_B
from repro_torch.core.compression import prune_params
from repro_torch.core.pytree_io import flatten_params
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import LMDataConfig, classification_data, lm_batches
from repro_torch.models.model import lm_loss, params_from_jax
from repro_torch.training import (OptimizerConfig, apply_updates, finetune_pruned_mlp,
                                  init_mlp_params, init_state, mlp_accuracy, train_loop,
                                  train_mlp)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_lib import _value_and_grad
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEQ, BATCH, STEPS = 16, 4, 3
# eps 1e-4 for the multi-step runs: at the default 1e-8, Adam scales every
# coordinate's step to about lr, also where the gradient is rounding noise
# of the two packages' different summation orders (|g| ~ 5e-8, tens of
# percent apart), so such parameters part by up to 2 * lr a step; a larger
# eps keeps those steps proportional to the gradient
OCFG = dict(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=STEPS)


def _close(got, want, **tol):
    """Every leaf of two dict trees (port tensors, JAX arrays) at ``tol``."""
    want = jax_flatten_params(want)
    got = flatten_params(got)
    assert list(got) == list(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(arr),
                                   err_msg=name, **tol)


# ----------------------------------------------------------- the paper's MLP
@pytest.fixture(scope="module", params=["table1_a", "table1_b"])
def mlp_runs(request):
    jcfg, cfg = {"table1_a": (JAX_TABLE1_A, TABLE1_A),
                 "table1_b": (JAX_TABLE1_B, TABLE1_B)}[request.param]
    x, y = jax_classification_data(3000, jcfg.in_dim, jcfg.num_classes, seed=1)
    xtr, ytr, xte, yte = x[:2000], y[:2000], x[2000:], y[2000:]
    init = jax_init_mlp_params(jax.random.PRNGKey(0), jcfg)
    trained = jax_train_mlp(jcfg, xtr, ytr, steps=100, params=init)
    pruned = jax_prune_params(jax.device_get(trained), 0.8)
    tuned = jax_finetune_pruned_mlp(jcfg, pruned, xtr, ytr, steps=50)
    t_init = params_from_jax(init, device="cpu")
    t_trained = train_mlp(cfg, xtr, ytr, steps=100, params=t_init)
    t_pruned = prune_params(t_trained, 0.8)
    t_tuned = finetune_pruned_mlp(cfg, t_pruned, xtr, ytr, steps=50)
    return dict(data=(xte, yte), jax=(trained, tuned), torch=(t_trained, t_tuned),
                t_pruned=t_pruned)


def test_mlp_data_and_init_match_jax_distribution():
    x, y = classification_data(500, 64, 10, seed=4)
    jx, jy = jax_classification_data(500, 64, 10, seed=4)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    p = init_mlp_params(TABLE1_A, seed=0, device="cpu")
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in p.items()} == \
        {k: {n: tuple(a.shape) for n, a in v.items()}
         for k, v in jax_init_mlp_params(jax.random.PRNGKey(0), JAX_TABLE1_A).items()}
    k = p["layer1"]["kernel"]
    assert abs(float(k.std()) - np.sqrt(2 / 784)) < 0.01 * np.sqrt(2 / 784) * 10
    assert float(p["layer1"]["bias_vec"].abs().max()) == 0.0


@pytest.mark.parametrize("stage", ["train_mlp", "finetune_pruned_mlp"])
def test_mlp_training_matches_jax(mlp_runs, stage):
    i = ["train_mlp", "finetune_pruned_mlp"].index(stage)
    want, got = mlp_runs["jax"][i], mlp_runs["torch"][i]
    _close(got, want, rtol=0, atol=1e-4)
    xte, yte = mlp_runs["data"]
    assert abs(mlp_accuracy(got, xte, yte) - jax_mlp_accuracy(want, xte, yte)) \
        <= 2 / len(yte)
    if stage == "finetune_pruned_mlp":
        pruned, tuned = flatten_params(mlp_runs["t_pruned"]), flatten_params(got)
        for name, p in pruned.items():
            zero = p == 0
            assert torch.equal(tuned[name][zero], torch.zeros_like(tuned[name][zero]))
            assert bool((tuned[name][~zero] != p[~zero]).any()), name


# ------------------------------------------------------------------ the LM
@pytest.fixture(scope="module")
def lm():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    data = JaxLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, batch_size=BATCH)
    batches = [b for b, _ in zip(jax_lm_batches(data), range(STEPS))]
    ours = lm_batches(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   batch_size=BATCH))
    for b, o in zip(batches, ours):
        assert all(np.array_equal(b[k], o[k]) for k in b)
    batches[0]["labels"][0, :3] = -100          # the masked-label path
    return jcfg, cfg, jparams, batches


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_lm_loss_and_grads_match_jax(lm):
    jcfg, cfg, jparams, batches = lm
    b = batches[0]

    def jax_loss(p):
        return jax_model.lm_loss(p, jcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    tb = _torch_batch(b)
    loss, parts = lm_loss(params, cfg, tb["tokens"], tb["labels"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["lm_loss"]), float(jparts["lm_loss"]), rtol=1e-5)
    assert float(parts["aux_loss"]) == 0.0
    (gl, _), grads = _value_and_grad(
        lambda p: lm_loss(p, cfg, tb["tokens"], tb["labels"]), params)
    assert float(gl) == float(loss)
    _close(grads, jgrads, rtol=1e-4, atol=1e-6)
    # the training path (unbound stacked leaves) and the serving path
    # (a select per unit) give the same loss
    with torch.no_grad():
        assert float(lm_loss(params, cfg, tb["tokens"], tb["labels"])[0]) == float(loss)


@pytest.mark.parametrize("case", [
    dict(), dict(weight_decay=0.0), dict(grad_clip=0.05),
    dict(grad_clip=0.05, weight_decay=0.3, warmup_steps=10, total_steps=20),
], ids=["default", "no_decay", "clipped", "clipped_warmup"])
def test_apply_updates_matches_jax(lm, case):
    """One AdamW update from a state three steps in (non-zero moments),
    on gradient-like values drawn with numpy."""
    _, _, jparams, _ = lm
    rng = np.random.default_rng(7)
    host = jax.device_get(jparams)

    def like(scale):
        return jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), host)

    grads, m = like(0.1), like(0.01)
    v = jax.tree_util.tree_map(np.abs, like(0.001))
    jstate = jax_opt.AdamWState(step=jnp.asarray(3, jnp.int32), m=m, v=v)
    jcfg = jax_opt.OptimizerConfig(**case)
    jnew, jnew_state, jm = jax_opt.apply_updates(jparams, grads, jstate, jcfg)
    state = opt.state_from_jax(jax.device_get(jstate), device="cpu")
    new, new_state, metrics = apply_updates(
        params_from_jax(jax_flatten_params(jparams), device="cpu"),
        params_from_jax(grads, device="cpu"), state, OptimizerConfig(**case))
    assert int(new_state.step) == 4 and new_state.step.dtype == torch.int32
    for key in ("grad_norm", "lr"):
        assert metrics[key].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=1e-5)
    if case.get("grad_clip"):
        assert float(metrics["grad_norm"]) > case["grad_clip"]      # the clip bites
    _close(new, jnew, rtol=1e-5, atol=1e-7)
    _close(new_state.m, jnew_state.m, rtol=1e-5, atol=1e-9)
    _close(new_state.v, jnew_state.v, rtol=1e-5, atol=1e-12)
    assert new_state.m is state.m                   # moments updated in place


def test_schedule_and_init_state(lm):
    _, _, jparams, _ = lm
    cfg = OptimizerConfig(warmup_steps=3, total_steps=10)
    jcfg = jax_opt.OptimizerConfig(warmup_steps=3, total_steps=10)
    for step in range(12):
        got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jax_opt.schedule(
            jcfg, jnp.asarray(step, jnp.int32))), rtol=1e-6)
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    state = init_state(params)
    assert int(state.step) == 0
    for m, v, p in zip(*(flatten_params(t).values() for t in (state.m, state.v, params))):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
        assert m is not v and not m.any()


def _jax_run(jcfg, jparams, batches, grad_accum, store=None):
    ocfg = jax_opt.OptimizerConfig(grad_accum=grad_accum, **OCFG)
    lines = []
    params, hist = jax_train_loop(jcfg, ocfg, iter(batches), STEPS, params=jparams,
                                  log_every=1, store=store, store_model="lm",
                                  checkpoint_every=1 if store else 0, log_fn=lines.append)
    return params, hist, lines


def _torch_run(cfg, jparams, batches, grad_accum, store=None):
    ocfg = OptimizerConfig(grad_accum=grad_accum, **OCFG)
    lines = []
    params, hist = train_loop(cfg, ocfg, iter(batches), STEPS,
                              params=params_from_jax(jax_flatten_params(jparams),
                                                     device="cpu"),
                              log_every=1, store=store, store_model="lm",
                              checkpoint_every=1 if store else 0, log_fn=lines.append)
    return params, hist, lines


def _history(store):
    """Each version's message, parent, production flag, and its weight and
    chunk rows."""
    rows = []
    for h in store.history("lm"):
        counts = tuple(store.conn.execute(
            f"SELECT COUNT(*) FROM {table} WHERE version_fk=?", (h["id"],)).fetchone()[0]
            for table in ("weight", "weight_chunk"))
        rows.append((h["message"], h["parent"], h["is_production"], counts))
    return rows


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_loop_matches_jax(lm, grad_accum):
    """grad_accum 1 checkpoints every step into each package's store."""
    jcfg, cfg, jparams, batches = lm
    # layers above 4,096 weights are stored as chunk pages, the rest as rows
    stores = (JaxWeightStore(":memory:", row_limit=4096),
              WeightStore(":memory:", row_limit=4096)) if grad_accum == 1 else (None, None)
    jp, jhist, jlines = _jax_run(jcfg, jparams, batches, grad_accum, stores[0])
    tp, hist, lines = _torch_run(cfg, jparams, batches, grad_accum, stores[1])
    assert hist["step"] == jhist["step"] == list(range(STEPS))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    assert hist["loss"][-1] < hist["loss"][0]
    _close(tp, jp, rtol=0, atol=1e-5)
    shape = [line.split("loss")[0] for line in jlines]
    assert [line.split("loss")[0] for line in lines] == shape
    if stores[0] is not None:
        # a weight row is written where the f32 value changed: a weight whose
        # step rounds away in one package and not in the other moves the
        # count by one, so rows agree to 1e-4 and chunk pages exactly
        want, got = _history(stores[0]), _history(stores[1])
        assert [h[:3] for h in got] == [h[:3] for h in want]
        for (_, _, _, (rows, pages)), (_, _, _, (want_rows, want_pages)) in zip(got, want):
            assert pages == want_pages and abs(rows - want_rows) <= 1e-4 * want_rows
        assert [h[0] for h in _history(stores[1])] == ["step 1", "step 2", "step 3"]
        assert all(sum(h[3]) > 0 for h in _history(stores[1]))
        for s in stores:
            s.close()
