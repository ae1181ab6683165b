"""Training loop library: train_step (forward + autograd + AdamW), metrics,
and WeightStore-backed checkpointing (the paper's versioned storage IS
the checkpoint substrate — every checkpoint is a delta commit).

Counterpart of ``repro.training.train_lib``.  Autograd through the
port's plain layers takes the place of ``jax.value_and_grad`` (no
function of that path reaches a Pallas kernel, and none has a custom
VJP).  Parameters are held without ``requires_grad``: each step
differentiates with respect to detached aliases of them (no copy), so
no ``.grad`` accumulates anywhere.  On the card every step is a CUDA
graph replay, the counterpart of the JAX package's ``jit``
(``training/compiled.py``); the CPU runs the steps eagerly, and so does
the card with the private ``_graph_backend`` returning ``None``.

The MLP half runs the paper's edge classifier (train, prune, fine-tune)
with the JAX package's batches: the same ``np.random.default_rng`` index
draws, plain SGD ``p - lr * g``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.models import model as model_lib
from repro_torch.models.layers import hint_sharding, split_rows
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.compiled import SgdStepGraph, TrainStepGraph


def _device(params) -> torch.device:
    return next(iter(flatten_params(params).values())).device


def _graph_backend(device: torch.device) -> Any:
    """The capture backend of the compiled steps on ``device``: CUDA
    graphs on the card, ``None`` (the eager steps) elsewhere.  Every loop
    asks it once; a comparison or a test replaces it."""
    if device.type != "cuda":
        return None
    from repro_torch.serving.compiled import CudaGraphBackend

    return CudaGraphBackend(device)


@dataclass
class TrainState:
    params: Any
    opt_state: opt_lib.AdamWState

    def as_tuple(self):
        return (self.params, self.opt_state)


def _value_and_grad(loss_fn: Callable, params: Any):
    """``((loss, aux), grads)`` of ``loss_fn(params) -> (loss, aux)``,
    grads in each parameter's dtype."""
    flat = {name: p.detach().requires_grad_() for name, p in flatten_params(params).items()}
    loss, aux = loss_fn(unflatten(flat))
    grads = torch.autograd.grad(loss, list(flat.values()))
    loss = loss.detach()
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss, aux), unflatten(dict(zip(flat, grads)))


def make_train_step(
    cfg: ModelConfig, ocfg: opt_lib.OptimizerConfig,
) -> Callable:
    """Returns train_step(params, opt_state, batch, *, out=None) ->
    (params, opt_state, metrics).

    ``batch`` = {tokens (B,S), labels (B,S)} (+ patch_embeds (B,P,D) for
    a VLM) as tensors on the params' device; ``out`` as in
    ``apply_updates``.
    """

    def grad_fn(params, batch):
        return _value_and_grad(
            lambda p: model_lib.lm_loss(p, cfg, batch["tokens"], batch["labels"],
                                        patch_embeds=batch.get("patch_embeds")), params)

    def train_step(params, opt_state, batch, *, out=None):
        m = ocfg.grad_accum
        if m <= 1:
            (loss, parts), grads = grad_fn(params, batch)
        else:
            # microbatch i is rows [i*B/m, (i+1)*B/m), each batch-sharded
            # under a mesh; grads accumulate in f32
            micro = {k: hint_sharding(split_rows(v, m), None, "batch", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
            grads = {name: torch.zeros_like(p, dtype=torch.float32)
                     for name, p in flatten_params(params).items()}
            device = _device(params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            aux = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(m):
                mb = {k: v[i] for k, v in micro.items()}
                (l, parts_i), g = grad_fn(params, mb)
                for name, gi in flatten_params(g).items():
                    grads[name] += gi.float()
                loss = loss + l
                aux = aux + parts_i["aux_loss"]
            # in place: a second f32 copy of the grads (13.6 GB at
            # qwen2.5-3b's width) would sit beside the moments at the peak
            grads = unflatten({name: g.div_(m) for name, g in grads.items()})
            loss = loss / m
            parts = {"lm_loss": loss, "aux_loss": aux / m}
        new_params, new_opt, om = opt_lib.apply_updates(params, grads, opt_state, ocfg,
                                                        out=out)
        metrics = {"loss": loss, **parts, **om}
        return new_params, new_opt, metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    ocfg: opt_lib.OptimizerConfig,
    batches: Iterator[Dict[str, np.ndarray]],
    num_steps: int,
    *,
    seed: int = 0,
    params: Any = None,
    log_every: int = 10,
    store=None,
    store_model: Optional[str] = None,
    checkpoint_every: int = 0,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> Tuple[Any, Dict[str, list]]:
    """Single-device training loop.  ``params`` default to
    ``init_params(cfg, seed=seed, device=device)``; given, they set the
    device, and are never written (the compiled step trains a copy).
    Every ``checkpoint_every`` steps the params are committed to
    ``store`` with the message ``"step N"``."""
    if params is None:
        params = model_lib.init_params(cfg, seed=seed, device=device)
    device = _device(params)
    opt_state = opt_lib.init_state(params)
    step_fn = make_train_step(cfg, ocfg)
    backend = _graph_backend(device)
    compiled = (None if backend is None else
                TrainStepGraph(step_fn, params, opt_state, backend))

    history: Dict[str, list] = {"loss": [], "step": []}
    t0 = time.time()
    for step in range(num_steps):
        if compiled is not None:
            metrics = compiled.step(next(batches))
            params = compiled.params
        else:
            batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in next(batches).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            loss = float(metrics["loss"])
            history["loss"].append(loss)
            history["step"].append(step)
            log_fn(f"step {step:5d}  loss {loss:.4f}  "
                   f"gnorm {float(metrics['grad_norm']):.3f}  "
                   f"lr {float(metrics['lr']):.2e}  "
                   f"({time.time() - t0:.1f}s)")
        if store is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
            store.commit(store_model or cfg.name, params, message=f"step {step + 1}")
    return params, history


# ------------------------------------------------------- paper-scale MLP
def init_mlp_params(mlp_cfg, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """The JAX package's distribution (normal * sqrt(2 / fan_in) kernels,
    zero biases), drawn from a ``torch.Generator`` seeded with ``seed``:
    the values differ from ``jax.random``'s."""
    dims = (mlp_cfg.in_dim, *mlp_cfg.hidden, mlp_cfg.num_classes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {}
    for i in range(len(dims) - 1):
        params[f"layer{i + 1}"] = {
            "kernel": torch.randn((dims[i], dims[i + 1]), generator=gen,
                                  dtype=torch.float32, device=device)
            * float(np.sqrt(2.0 / dims[i])),
            "bias_vec": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
    return params


def mlp_forward(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(1, n + 1):
        p = params[f"layer{i}"]
        x = x @ p["kernel"] + p["bias_vec"]
        if i < n:
            x = torch.relu(x)
    return x


def mlp_accuracy(params, x: np.ndarray, y: np.ndarray) -> float:
    device = _device(params)
    with torch.no_grad():
        logits = mlp_forward(params, torch.from_numpy(np.asarray(x)).to(device))
        hits = int((logits.argmax(-1) == torch.from_numpy(np.asarray(y)).to(device)).sum())
    # the mean as XLA computes jnp.mean: times the float32 reciprocal of n
    return float(np.float32(hits) * (np.float32(1) / np.float32(len(y))))


def _xent(params, xb, yb):
    logp = torch.log_softmax(mlp_forward(params, xb), dim=-1)
    return -torch.gather(logp, 1, yb[:, None].long()).mean(), {}


def _xent_grads(params, xb, yb):
    return _value_and_grad(lambda p: _xent(p, xb, yb), params)[1]


def _sgd(params, x, y, *, steps, lr, seed, batch, masks=None):
    """``steps`` SGD steps on batches drawn as the JAX package draws them;
    with ``masks``, each update is multiplied by its mask.  On the card
    one CUDA graph (``SgdStepGraph``) over a copy of ``params``."""
    device = _device(params)
    xs = torch.from_numpy(np.asarray(x)).to(device)
    ys = torch.from_numpy(np.asarray(y)).to(device)
    rng = np.random.default_rng(seed)
    backend = _graph_backend(device)
    if backend is not None:
        compiled = SgdStepGraph(_xent_grads, params, xs, ys, batch, lr=lr, masks=masks,
                                backend=backend)
        for _ in range(steps):
            compiled.step(rng.integers(0, len(x), batch))
        return compiled.params
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(x), batch)).to(device)
        flat_g = flatten_params(_xent_grads(params, xs[idx], ys[idx]))
        new = {}
        for name, p in flatten_params(params).items():
            p = p.detach() - lr * flat_g[name]
            new[name] = p if masks is None else p * masks[name]
        params = unflatten(new)
    return params


def train_mlp(
    mlp_cfg, x: np.ndarray, y: np.ndarray, *, steps: int = 300, lr: float = 1e-2,
    seed: int = 0, params=None, batch: int = 256, device="cuda",
) -> Dict[str, Any]:
    """Train the paper's small classifier to ~98% (or fine-tune pruned).
    ``params`` default to ``init_mlp_params(mlp_cfg, seed=seed,
    device=device)``; given, they set the device."""
    if params is None:
        params = init_mlp_params(mlp_cfg, seed=seed, device=device)
    return _sgd(params, x, y, steps=steps, lr=lr, seed=seed, batch=batch)


def finetune_pruned_mlp(mlp_cfg, params, x, y, *, steps: int = 150, lr: float = 5e-3,
                        seed: int = 1):
    """Fine-tune while preserving the pruned mask (Fig. 3's fine-tune
    stage): pruned zeros stay exactly zero."""
    masks = {name: (p != 0).float() for name, p in flatten_params(params).items()}
    return _sgd(params, x, y, steps=steps, lr=lr, seed=seed, batch=256,
                masks=masks)
