"""The compiled training steps of the port: CUDA graphs of ``train_loop``'s
step and of the paper MLP's SGD step.

Counterpart of the JAX package's jits in ``repro/training/train_lib.py``:
``train_loop`` jit-compiles ``make_train_step``'s step (forward,
``value_and_grad``, the ``grad_accum`` micro-batches and AdamW) and
retraces it per batch shape; ``train_mlp`` and ``finetune_pruned_mlp``
jit their SGD step.  Here each is captured once per key as a CUDA graph
and replayed, on the capture backend of ``serving/compiled.py``
(``CudaGraphBackend`` on the card; the CPU tests pass a recording one).

* **Static state.**  The parameters are copied once into static
  buffers, which the graph updates in place (``apply_updates(...,
  out=)``; the SGD step copies ``p - lr * g`` back): the caller's
  tensors are never written, and the returned parameters are these
  buffers, valid after the graph and its pool are gone.  AdamW's ``m``
  and ``v`` are updated in place as in the eager step, its ``step``
  copied into a static counter.
* **Static inputs**, refilled before every step by an asynchronous
  copy from pinned host memory (``_Input``): the batch's arrays, one set
  per key (the arrays' names, shapes and dtypes); the MLP step's index draw (batch,)
  int64, which gathers its rows from the whole data set on the device.
* **Static outputs**: the LM step's metrics (``loss``, ``lm_loss``,
  ``aux_loss``, ``grad_norm``, ``lr``), valid until the next step.
* **Capture.**  A step is not idempotent (AdamW moves ``m`` and ``v``;
  a snapshot of them would cost 27 GB at full width), so a new key's
  warm-up on the side stream IS that step, the capture that follows
  records it without running it, and every later step of the key is a
  replay: the history is the eager loop's step for step.  A failed
  capture or replay raises; nothing falls back to the eager step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.serving.compiled import _Input


def _static_copy(params: Any) -> Any:
    """The parameters' static buffers: a copy of every leaf."""
    return unflatten({name: p.detach().clone() for name, p in flatten_params(params).items()})


class TrainStepGraph:
    """``train_loop``'s step (``make_train_step``'s ``train_step``) as one
    CUDA graph per batch key, over static copies of ``params`` and the
    optimizer state ``opt_state`` (see the module docstring).
    ``step(batch)`` runs one step on a dict of host arrays and returns
    the static metrics; ``params`` holds the current parameters."""

    def __init__(self, train_step: Callable, params: Any, opt_state: Any, backend: Any):
        self.train_step = train_step
        self.backend = backend
        self.params = _static_copy(params)
        self.device = next(iter(flatten_params(self.params).values())).device
        self.opt_state = opt_state
        self.metrics: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[Tuple[Any, ...], Dict[str, _Input]] = {}
        self.graphs: Dict[Tuple[Any, ...], Any] = {}
        self.captures = 0
        self.replays = 0

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        key = tuple((k, a.shape, a.dtype.str) for k, a in sorted(arrays.items()))
        if key not in self.inputs:
            self.inputs[key] = {k: _Input(a.shape, torch.from_numpy(a).dtype, self.device)
                                for k, a in arrays.items()}
        inputs = self.inputs[key]
        for k, a in arrays.items():
            inputs[k].fill(a)
        graph = self.graphs.get(key)
        if graph is None:
            fn = self._step_fn(inputs)
            self.backend.warmup(fn)                  # this step
            self.graphs[key] = self.backend.capture(fn)
            self.captures += 1
        else:
            self.backend.replay(graph)
            self.replays += 1
        return self.metrics

    def _step_fn(self, inputs: Dict[str, _Input]) -> Callable[[], None]:
        batch = {k: buf.dev for k, buf in inputs.items()}
        state = self.opt_state

        def fn():
            _, new_state, metrics = self.train_step(self.params, state, batch, out=self.params)
            state.step.copy_(new_state.step)
            for k, v in metrics.items():
                if k not in self.metrics:        # allocated by the warm-up
                    self.metrics[k] = torch.empty_like(v)
                self.metrics[k].copy_(v)

        return fn


class SgdStepGraph:
    """The paper MLP's SGD step (``train_lib._sgd``) as one CUDA graph per
    (batch, masked): ``step(idx)`` gathers the rows ``idx`` of the static
    data set ``xs``/``ys``, takes the cross-entropy's gradient and writes
    ``p - lr * g`` (times its mask, with ``masks``) into the static
    parameters ``params``."""

    def __init__(self, grad_fn: Callable, params: Any, xs: torch.Tensor, ys: torch.Tensor,
                 batch: int, *, lr: float, masks: Optional[Dict[str, torch.Tensor]],
                 backend: Any):
        self.backend = backend
        self.params = _static_copy(params)
        self.idx = _Input((int(batch),), torch.int64, xs.device)
        flat = flatten_params(self.params)

        def fn():
            idx = self.idx.dev
            grads = flatten_params(grad_fn(self.params, xs[idx], ys[idx]))
            for name, p in flat.items():
                new = p - lr * grads[name]
                p.copy_(new if masks is None else new * masks[name])

        self._fn = fn
        self.graph = None
        self.captures = 0
        self.replays = 0

    def step(self, idx: np.ndarray) -> None:
        self.idx.fill(idx)
        if self.graph is None:
            self.backend.warmup(self._fn)            # this step
            self.graph = self.backend.capture(self._fn)
            self.captures += 1
        else:
            self.backend.replay(self.graph)
            self.replays += 1
