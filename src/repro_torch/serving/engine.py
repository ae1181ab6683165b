"""Serving engine of the port: the serving steps the gateway calls (the
bucket and chunked prefill, the suffix prefill of a prefix-cache hit,
the gather/scatter and kernel-resident paged decode), the host
sampler, and ``ServingEngine``, the batch engine with per-tier licensed
weight views.

Counterpart of ``repro/serving/engine.py``.  The JAX package ``vmap``\\ s
a batch-1 step over lanes; here the lane axis is the model's batch
dimension, with per-lane positions written out.  Every stochastic draw
of the port, the gateway's and the engine's, is computed on the
logits' device by :func:`sample_rows` from uniforms drawn on the host
by CPU ``torch.Generator``\\ s: one uniform a row, uploaded with the
rows' temperatures and top-k in one copy.  The gateway seeds one
generator per (request seed, token index) (:func:`lane_uniform`), so a
restarted request reproduces its tokens, and its fused and host modes
draw through the same call on the same device rows, so they give the
same tokens.  The draws cannot match the JAX package's ``fold_in``
keys, so only greedy tokens are comparable across the two.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import FULL_TIER, LicenseTier, apply_license
from repro_torch.models import model as model_lib
from repro_torch.serving.scheduler import TierViewCache


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


def lane_uniform(seed: int, n_out: int) -> float:
    """The uniform a gateway lane draws its ``n_out``-th token with: the
    first number of a CPU generator seeded per (request seed, token
    index)."""
    gen = torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 20) ^ int(n_out))
    return float(torch.rand(1, generator=gen))


def sample_rows(rows: torch.Tensor, uniforms: Sequence[float],
                temperatures: Sequence[float], top_ks: Sequence[int]) -> torch.Tensor:
    """One categorical draw from each of ``rows`` (m, V), computed on
    their device: row ``i`` scaled by ``temperatures[i]`` (> 0),
    restricted to its ``top_ks[i]`` largest logits when that is > 0,
    and drawn by inverse transform, ``uniforms[i]`` against the
    cumulative probabilities (the first index whose sum passes it,
    capped at the first that reaches the total, so a rounding of the
    uniform up to the total never lands on a logit of probability 0 past
    the last live one).  The three host sequences go to the device in
    one copy; the divisor is a tensor, as CUDA turns a division by a
    Python scalar into a product with its reciprocal.  A row's token
    depends on its row, uniform, temperature and k only.  Returns (m,)
    int32 on the rows' device."""
    v = rows.shape[-1]
    ks = [min(max(0, int(k)), v) for k in top_ks]
    knobs = torch.tensor([list(uniforms), list(temperatures), ks],
                         dtype=torch.float32).to(rows.device)
    u, temperature, k = knobs[0, :, None], knobs[1, :, None], knobs[2].long()
    scaled = rows.float() / temperature
    if max(ks):
        kth = torch.topk(scaled, max(ks), dim=-1).values.gather(
            1, (k - 1).clamp(min=0)[:, None])
        kth = kth.masked_fill(k[:, None] == 0, -float("inf"))
        scaled = scaled.masked_fill(scaled < kth, -float("inf"))
    cdf = torch.cumsum(torch.softmax(scaled, -1), -1)
    total = cdf[:, -1:].contiguous()
    drawn = torch.minimum(torch.searchsorted(cdf, u * total, right=True),
                          torch.searchsorted(cdf, total))
    return drawn[:, 0].to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Tokens (int32, on the logits' device) from a (B, V) batch or a
    (V,) row: greedy (the first argmax) when ``temperature <= 0``, else
    a temperature-scaled categorical draw after top-k
    (:func:`sample_rows`), one uniform a row from ``generator``, a CPU
    generator."""
    if temperature <= 0:
        return torch.argmax(logits, -1).to(torch.int32)
    rows = logits.reshape(-1, logits.shape[-1])
    m = rows.shape[0]
    uniforms = torch.rand(m, generator=generator).tolist()
    drawn = sample_rows(rows, uniforms, [temperature] * m, [top_k] * m)
    return drawn.reshape(logits.shape[:-1])


@dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    license: str = "full"
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)


class ServingEngine:
    """Batched serving with per-tier licensed weight views.

    Weight views are built once per tier (masking is elementwise and
    cheap beside serving) and cached: the paper's "unlimited licenses,
    one stored model".  Each group of same-tier requests prefills in one
    step into a fresh contiguous cache and decodes one ``serve_step`` a
    token.  On the card both steps are CUDA graphs
    (``compiled.EngineGraphs`` on the private ``_graphs``: one per
    (view, lanes, prompt width, capacity) and (view, lanes, capacity),
    the JAX engine's jit keys); the CPU runs them eagerly, and so does
    the card with ``_graphs`` set to ``None``.  The gateway
    (:meth:`gateway`) is the fast path, with the paged pool and the
    kernels.

    ``quantized=True``: ONE int8 store serves every tier, each tier's
    intervals fused into the dequant inside every step (one
    ``masked_dequant`` launch per int8 leaf of a unit on the card).
    ``device`` is where the weights live and the engine runs (default
    ``cuda``); params elsewhere raise ``ValueError``.
    """

    def __init__(self, cfg: ModelConfig, params: Any,
                 tiers: Optional[Dict[str, LicenseTier]] = None,
                 quantized: bool = False, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['tok'].device}, "
                             f"the engine on {self.device}")
        self.quantized = bool(quantized)
        if self.quantized:
            from repro_torch.serving.quantized import quantize_serving_params

            self.base_params = quantize_serving_params(params)
        else:
            self.base_params = params
        self.tiers = dict(tiers or {})
        self.tiers.setdefault("full", FULL_TIER)
        # (tier, version=None)-keyed views, the gateway's cache; the
        # engine is versionless
        self._views = TierViewCache(self._build_view, capacity=64)
        from repro_torch.serving.compiled import EngineGraphs, StoreGraphs

        self._store_graphs = StoreGraphs()     # the in-scan tiers' one set
        # the compiled prefill and decode: CUDA graphs on the card
        self._graphs = EngineGraphs(self) if self.device.type == "cuda" else None

    def _build_view(self, license_name: str, _version):
        """(params, intervals) licensed view, built once per tier: a
        ``compiled.View`` whose graphs go with it (in-scan, every tier's
        view holds the store's one set)."""
        from repro_torch.serving.compiled import GraphSet, View

        tier = self.tiers.get(license_name)
        if tier is None:
            raise KeyError(f"unknown license tier {license_name!r}")
        if self.quantized:
            from repro_torch.serving.quantized import tier_intervals

            # one store, every tier
            return View(self.base_params, tier_intervals(tier, device=self.device),
                        self._store_graphs.get(None, self.base_params))
        params = apply_license(self.base_params, tier)
        return View(params, None, GraphSet(params))

    def params_for(self, license_name: str):
        return self._views.get(license_name)[0]

    def intervals_for(self, license_name: str):
        if not self.quantized:
            return None
        return self._views.get(license_name)[1]

    def gateway(self, **kw):
        """A :class:`~repro_torch.serving.gateway.LicensedGateway` over
        this engine's weights, tiers and device (the continuous-batching
        front end).  Quantization follows the engine; construct
        ``LicensedGateway`` directly to choose another weight-store
        mode."""
        if "quantized" in kw or "already_quantized" in kw:
            raise ValueError("gateway() mirrors the engine's quantization; "
                             "construct LicensedGateway directly to override")
        from repro_torch.serving.gateway import LicensedGateway

        kw.setdefault("device", self.device)
        return LicensedGateway(self.cfg, self.base_params, tiers=self.tiers,
                               quantized=self.quantized,
                               already_quantized=self.quantized, **kw)

    def generate(self, requests: List[Request], *, seed: int = 0) -> List[Request]:
        """Serve a batch of requests, grouped by tier.  Greedy tokens
        are the argmax on the device; a group at a temperature draws on
        the device from uniforms of one CPU generator seeded with
        ``seed``.  Only the token ids come to the host, once a step."""
        by_tier: Dict[str, List[Request]] = {}
        for r in requests:
            by_tier.setdefault(r.license, []).append(r)
        for tier_name, group in by_tier.items():
            self._generate_group(group, tier_name, seed)
        return requests

    def _generate_group(self, group: List[Request], tier_name: str, seed: int):
        view = self._views.get(tier_name)
        params, li = view
        cfg, dev, graphs = self.cfg, self.device, self._graphs
        b = len(group)
        max_prompt = max(len(r.prompt) for r in group)
        max_new = max(r.max_new_tokens for r in group)
        capacity = max_prompt + max_new
        toks = right_align([r.prompt for r in group], max_prompt, b)
        if graphs is not None:
            logits, greedy = graphs.prefill(view, toks, capacity)
        else:
            cache = model_lib.init_cache(cfg, b, capacity, device=dev)
            logits, cache = prefill_step(params, cfg, torch.from_numpy(toks).to(dev), cache,
                                         license_intervals=li)
        gen = torch.Generator().manual_seed(int(seed))
        temperature = group[0].temperature
        # a graph's greedy tokens are its static argmax of the logits
        drawn = graphs is None or temperature > 0
        cur = sample(logits, gen, temperature=temperature) if drawn else greedy
        # one copy of b token ids a step; the tokens stay on the device
        for i, t in enumerate(cur.tolist()):
            group[i].out_tokens.append(t)
        for step in range(max_new - 1):
            if graphs is not None:
                logits, greedy = graphs.decode(view, cur, max_prompt + step, capacity)
            else:
                pos = torch.full((b,), max_prompt + step, dtype=torch.int32, device=dev)
                logits, cache = serve_step(params, cfg, cur[:, None], cache, pos, li)
            cur = sample(logits, gen, temperature=temperature) if drawn else greedy
            for i, t in enumerate(cur.tolist()):
                if len(group[i].out_tokens) < group[i].max_new_tokens:
                    group[i].out_tokens.append(t)
