"""The compiled training steps (``repro_torch.training.compiled``) on the
CPU.

On the card ``train_loop``'s step (forward, autograd, the ``grad_accum``
micro-batches, AdamW) is one CUDA graph per batch key, and the paper
MLP's SGD step one per (batch, masked).  Here the loops take the
recording backend of ``test_torch_engine_graphs.py`` through the private
``train_lib._graph_backend``: its warm-up runs the step, its capture
records the function and runs nothing (as CUDA's: a capture that ran
AdamW would apply it twice), its replay runs it again.  The first step
of a key is then its warm-up and every later one a replay.

Against the eager loops (``_graph_backend`` -> ``None``) the graph loops
must agree bit for bit: history and log lines, params, AdamW's ``m``,
``v`` and ``step``, every checkpoint's rows, pages and weights; the
MLP's params, with pruned zeros exactly 0.  Against the JAX package at
``test_torch_training.py``'s tolerances.  The caller's params are never
written.  One ``gpu`` test runs both loops on the card.
"""
import jax
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
from repro.training import finetune_pruned_mlp as jax_finetune_pruned_mlp
from repro.training import mlp_accuracy as jax_mlp_accuracy
from repro.training import train_mlp as jax_train_mlp
from repro.training.train_lib import init_mlp_params as jax_init_mlp_params

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.paper_mlp import TABLE1_A, TABLE1_B
from repro_torch.core.compression import prune_params
from repro_torch.core.pytree_io import flatten_params
from repro_torch.core.weightstore import WeightStore
from repro_torch.models.model import params_from_jax
from repro_torch.training import (OptimizerConfig, finetune_pruned_mlp, mlp_accuracy,
                                  train_loop, train_mlp)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_lib
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_engine_graphs import Recorder
from test_torch_training import BATCH, OCFG, SEQ, STEPS, _close, _history, _jax_run


class Backends:
    """``train_lib._graph_backend`` for a test: a new backend a loop from
    ``make`` (a recorder by default; kept in ``made``), or ``None`` for
    the eager loop."""

    def __init__(self):
        self.made = []
        self.eager = False
        self.make = lambda device: Recorder()

    def __call__(self, device):
        if self.eager:
            return None
        self.made.append(self.make(device))
        return self.made[-1]


@pytest.fixture
def backends(monkeypatch):
    b = Backends()
    monkeypatch.setattr(train_lib, "_graph_backend", b)
    return b


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    data = JaxLMDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, batch_size=BATCH)
    batches = [b for b, _ in zip(jax_lm_batches(data), range(STEPS))]
    batches[0]["labels"][0, :3] = -100          # the masked-label path
    return jcfg, cfg, jparams, batches


def _port_run(cfg, params, batches, grad_accum, store, monkeypatch):
    """One port loop; returns (params, history, lines, AdamW state: the
    loop's own, and the last ``apply_updates`` returned)."""
    states, last = [], []
    init_state, apply_updates = opt_lib.init_state, opt_lib.apply_updates

    def kept_init(p):
        states.append(init_state(p))
        return states[-1]

    def kept_apply(*a, **kw):
        out = apply_updates(*a, **kw)
        last[:] = [out[1]]
        return out

    monkeypatch.setattr(opt_lib, "init_state", kept_init)
    monkeypatch.setattr(opt_lib, "apply_updates", kept_apply)
    lines = []
    try:
        got, hist = train_loop(cfg, OptimizerConfig(grad_accum=grad_accum, **OCFG),
                               iter(batches), STEPS, params=params, log_every=1, store=store,
                               store_model="lm", checkpoint_every=1 if store else 0,
                               log_fn=lines.append)
    finally:
        monkeypatch.setattr(opt_lib, "init_state", init_state)
        monkeypatch.setattr(opt_lib, "apply_updates", apply_updates)
    return got, hist, lines, states[0], last[0]


def _equal(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert list(fa) == list(fb)
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name


@pytest.mark.parametrize("grad_accum,checkpoint", [(1, True), (2, False)],
                         ids=["accum1_checkpointed", "accum2"])
def test_graph_loop_matches_eager_and_jax(lm, backends, monkeypatch, grad_accum, checkpoint):
    jcfg, cfg, jparams, batches = lm
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    before = {k: v.clone() for k, v in flatten_params(params).items()}
    stores = [WeightStore(":memory:", row_limit=4096) if checkpoint else None
              for _ in range(2)]
    backends.eager = True
    ep, ehist, elines, _, estate = _port_run(cfg, params, batches, grad_accum, stores[0],
                                             monkeypatch)
    backends.eager = False
    gp, ghist, glines, gstate, glast = _port_run(cfg, params, batches, grad_accum, stores[1],
                                                 monkeypatch)
    rec, = backends.made
    # the first step is the capture's warm-up, the others replays
    assert (rec.captures, rec.replays) == (1, STEPS - 1)
    assert ghist == ehist
    assert [line.split("(")[0] for line in glines] == [line.split("(")[0] for line in elines]
    _equal(gp, ep)
    _equal(gstate.m, estate.m)
    _equal(gstate.v, estate.v)
    assert int(gstate.step) == int(glast.step) == int(estate.step) == STEPS
    assert gstate.step.dtype == torch.int32
    _equal(params, before)                                    # never written
    if checkpoint:
        assert _history(stores[1]) == _history(stores[0])
        for h in stores[0].history("lm"):
            want, got = stores[0].checkout("lm", h["id"]), stores[1].checkout("lm", h["id"])
            assert all(np.array_equal(got[k], want[k]) for k in want)
    # against the JAX loop, as test_torch_training.py holds the eager one
    jstore = JaxWeightStore(":memory:", row_limit=4096) if checkpoint else None
    jp, jhist, jlines = _jax_run(jcfg, jparams, batches, grad_accum, jstore)
    np.testing.assert_allclose(ghist["loss"], jhist["loss"], rtol=1e-4)
    _close(gp, jp, rtol=0, atol=1e-5)
    if checkpoint:
        assert [h[:3] for h in _history(stores[1])] == [h[:3] for h in _history(jstore)]
        jstore.close()
    for s in stores:
        if s is not None:
            s.close()


@pytest.fixture(scope="module", params=["table1_a", "table1_b"])
def mlp(request):
    jcfg, cfg = {"table1_a": (JAX_TABLE1_A, TABLE1_A),
                 "table1_b": (JAX_TABLE1_B, TABLE1_B)}[request.param]
    x, y = jax_classification_data(3000, jcfg.in_dim, jcfg.num_classes, seed=1)
    xtr, ytr, xte, yte = x[:2000], y[:2000], x[2000:], y[2000:]
    init = jax_init_mlp_params(jax.random.PRNGKey(0), jcfg)
    trained = jax_train_mlp(jcfg, xtr, ytr, steps=100, params=init)
    tuned = jax_finetune_pruned_mlp(jcfg, jax_prune_params(jax.device_get(trained), 0.8),
                                    xtr, ytr, steps=50)
    return dict(cfg=cfg, data=(xtr, ytr, xte, yte), init=init, jax=(trained, tuned))


def _mlp_run(m):
    xtr, ytr, _, _ = m["data"]
    init = params_from_jax(m["init"], device="cpu")
    before = {k: v.clone() for k, v in flatten_params(init).items()}
    trained = train_mlp(m["cfg"], xtr, ytr, steps=100, params=init)
    pruned = prune_params(trained, 0.8)
    pruned_before = {k: v.clone() for k, v in flatten_params(pruned).items()}
    tuned = finetune_pruned_mlp(m["cfg"], pruned, xtr, ytr, steps=50)
    _equal(init, before)                                        # never written
    _equal(pruned, pruned_before)
    return trained, pruned, tuned


def test_graph_mlp_matches_eager_and_jax(mlp, backends):
    """``train_mlp`` and ``finetune_pruned_mlp`` through one graph each
    (100 and 50 steps: one warm-up, the rest replays) against the eager
    steps bit for bit, pruned zeros exactly 0, and the JAX package's
    params at atol 1e-4 and accuracy within 2 / len(test set)."""
    backends.eager = True
    e_trained, _, e_tuned = _mlp_run(mlp)
    backends.eager = False
    g_trained, g_pruned, g_tuned = _mlp_run(mlp)
    assert [(r.captures, r.replays) for r in backends.made] == [(1, 99), (1, 49)]
    _equal(g_trained, e_trained)
    _equal(g_tuned, e_tuned)
    for name, p in flatten_params(g_pruned).items():
        zero = p == 0
        assert not flatten_params(g_tuned)[name][zero].any(), name
    _, _, xte, yte = mlp["data"]
    for got, want in zip((g_trained, g_tuned), mlp["jax"]):
        _close(got, want, rtol=0, atol=1e-4)
        assert abs(mlp_accuracy(got, xte, yte) - jax_mlp_accuracy(want, xte, yte)) \
            <= 2 / len(yte)


@pytest.mark.gpu
def test_cuda_graph_loops_match_eager(lm, backends):
    """On the card: ``train_loop`` and the MLP steps through CUDA graphs
    against the eager loops on the same inputs (losses within 1e-3
    relative: cuBLAS may pick other algorithms inside a capture; pruned
    zeros exactly 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serving.compiled import CudaGraphBackend

    _, cfg, jparams, batches = lm
    params = params_from_jax(jax_flatten_params(jparams), device="cuda")
    backends.make = CudaGraphBackend
    runs = []
    for eager in (True, False):
        backends.eager = eager
        runs.append(train_loop(cfg, OptimizerConfig(**OCFG), iter(batches), STEPS,
                               params=params, log_every=1, log_fn=lambda line: None)[1])
    np.testing.assert_allclose(runs[1]["loss"], runs[0]["loss"], rtol=1e-3)
    x, y = jax_classification_data(2000, TABLE1_A.in_dim, TABLE1_A.num_classes, seed=1)
    pruned = prune_params(train_mlp(TABLE1_A, x, y, steps=50, device="cuda"), 0.8)
    tuned = finetune_pruned_mlp(TABLE1_A, pruned, x, y, steps=20)
    for name, p in flatten_params(pruned).items():
        assert not flatten_params(tuned)[name][p == 0].any(), name
    assert len(backends.made) == 3
