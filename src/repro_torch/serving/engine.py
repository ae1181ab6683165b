"""Serving steps of the port: the bucket and chunked prefill, the suffix
prefill of a prefix-cache hit, the gather/scatter and kernel-resident
paged decode, and per-lane sampling.

Counterpart of the functions of ``repro/serving/engine.py`` the gateway
calls (``ServingEngine``, ``Request`` and the host ``sample`` are not
ported).  The JAX package ``vmap``\\ s a batch-1 step over lanes;
here the lane axis is the model's batch dimension, with per-lane
positions written out.  Sampling draws from a ``torch.Generator`` seeded
per (request seed, token index), so a restarted request reproduces its
tokens; the draws cannot match the JAX package's ``fold_in`` keys, so
only greedy tokens are comparable across the two.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


def prefill_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict[str, Any],
                 patch_embeds: Optional[torch.Tensor] = None, license_intervals=None):
    """Fill a fresh (zero) cache from a token batch (B, S) at positions
    0..S-1 (the bucket prefill), after a vision prefix of
    ``patch_embeds`` (B, P, D) where one is given (then positions
    0..P+S-1); returns (last-token logits (B, V), cache)."""
    logits, cache = model_lib.forward(params, cfg, tokens, patch_embeds=patch_embeds,
                                      cache=cache, pos=0,
                                      license_intervals=license_intervals)
    return logits[:, -1], cache


def prefill_suffix_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                        cache: Dict[str, Any], pos, license_intervals=None):
    """Suffix prefill: extend a cache already holding positions ``[0,
    pos)`` with ``tokens`` (B, W) — the uncached tail of a prompt whose
    prefix the prefix cache restored.  ``pos`` is an int or (B,) per
    lane.  Attention reads the resident cache, and the *full* per-step
    logits (B, W, V) come back: the caller picks the row of each lane's
    last real token."""
    return model_lib.forward(params, cfg, tokens, cache=cache, pos=pos,
                             license_intervals=license_intervals, attend_cache=True)


def stack_lane_caches(cfg: ModelConfig, b: int, capacity: int, device="cuda"):
    """``b`` independent lane caches, zeroed (every leaf's pristine value,
    recurrent state included, so a bucket prefill starts each lane from
    the initial state): the layout :func:`prefill_chunk_step` and
    :func:`serve_step` take.  The JAX package stacks batch-1 caches on a
    new leading axis for ``vmap``; here the lane is the model's batch
    axis (after the unit axis, first on a tail block's leaves), so this
    is ``init_cache(cfg, b, capacity)``."""
    return model_lib.init_cache(cfg, b, capacity, device=device)


def prefill_chunk_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                       caches: Dict[str, Any], pos: torch.Tensor,
                       chunk_valid: Optional[torch.Tensor] = None,
                       license_intervals=None):
    """Left-aligned chunked prefill: advance each lane's cursor by up to
    W tokens against its own cache.

    ``tokens`` (B, W) holds each lane's next chunk starting at that
    lane's absolute cursor ``pos`` (B,); a lane with fewer tokens left
    right-pads its row and reports its real rows in ``chunk_valid`` (B,).
    ``caches`` is a contiguous batch cache (``PagedCachePool.gather``).
    With an int8 store as ``params`` and a tier's ``license_intervals``
    the units are dequantized in the step (``models.model.forward``).
    Returns the per-chunk logits (B, W, V) and the (in-place updated)
    caches."""
    return model_lib.forward(params, cfg, tokens, cache=caches, pos=pos,
                             license_intervals=license_intervals,
                             attend_cache=True, chunk_valid=chunk_valid)


def serve_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict[str, Any],
               pos, license_intervals=None):
    """ONE decode step over contiguous lane caches (the gather/scatter
    decode): ``tokens`` (B, 1), ``pos`` (B,) each lane's absolute
    position, ``cache`` holding each lane's ``len``.  Returns
    (last-token logits (B, V), cache)."""
    logits, cache = model_lib.forward(params, cfg, tokens, cache=cache, pos=pos,
                                      license_intervals=license_intervals)
    return logits[:, -1], cache


def serve_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                     cache: Dict[str, Any], tables: torch.Tensor,
                     pos: torch.Tensor, license_intervals=None, *, kernel: bool):
    """ONE kernel-resident decode step over the paged pool.

    ``tokens`` (B, 1); ``cache`` from ``PagedCachePool.decode_cache``;
    ``tables`` (B, T) int32 trimmed to the micro-batch's used width;
    ``pos`` (B,) int32 absolute positions.  ``kernel=True`` writes and
    attends through the Hopper kernels, ``False`` through the plain path;
    ``license_intervals`` as in ``prefill_chunk_step``.  Nothing here
    synchronises or copies from the host, so the step is capturable in
    a CUDA graph (``serving/compiled.py``).
    Returns (last-token logits (B, V), cache)."""
    logits, cache = model_lib.forward(params, cfg, tokens, cache=cache, pos=pos,
                                      license_intervals=license_intervals,
                                      paged_tables=tables, paged_kernel=kernel)
    return logits[:, -1], cache


def right_align(prompts: Sequence[np.ndarray], width: int, rows: int) -> np.ndarray:
    """(rows, width) int32 token matrix; short prompts padded on the left
    with their own first token (position-consistent, never attends
    ahead): the bucket prefill's prompt rows."""
    toks = np.zeros((rows, width), np.int32)
    for i, p in enumerate(prompts):
        if len(p) == 0:
            raise ValueError(f"empty prompt at row {i}")
        toks[i, width - len(p):] = p
        toks[i, : width - len(p)] = p[0]
    return toks


def lane_generator(seed: int, n_out: int, device) -> torch.Generator:
    """The generator a lane draws its ``n_out``-th token from."""
    return torch.Generator(device=device).manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 20) ^ int(n_out))


def sample_lane(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float, top_k: int) -> torch.Tensor:
    """One lane's token from its logits row (V,): greedy (argmax) when
    ``temperature <= 0``, else a temperature-scaled categorical draw,
    restricted to the ``top_k`` largest logits when ``top_k > 0``."""
    if temperature <= 0:
        return torch.argmax(logits, -1).to(torch.int32)
    scaled = logits.float() / max(temperature, 1e-6)
    if top_k:
        kth = torch.topk(scaled, min(int(top_k), scaled.shape[-1])).values[-1]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -float("inf")),
                             scaled)
    probs = torch.softmax(scaled, -1)
    return torch.multinomial(probs, 1, generator=generator)[0].to(torch.int32)
