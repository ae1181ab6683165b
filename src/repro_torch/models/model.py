"""Decoder-only model of the port over the ported block kinds: the dense
GQA decoders (qwen2.5-3b, granite-34b, minitron-8b, nemotron-4-15b), the
DeepSeek MoE models (deepseek-moe-16b with GQA attention,
deepseek-v2-lite-16b with MLA), the recurrent family (mamba2-130m:
Mamba-2 SSD blocks; recurrentgemma-2b: RG-LRU blocks and sliding-window
attention, 2:1) and the front-end stubs: musicgen-large (LayerNorm, MHA
over codec tokens; its ``"audio"`` front end has no code, as in the JAX
model) and internvl2-26b (projected vision patch embeddings prepended to
the text tokens).  Any GQA config may keep its K/V in int8
(``kv_cache_int8``).

Counterpart of ``repro/models/model.py``.  Layers are grouped into
*pattern units*, one cycle of ``cfg.layer_pattern`` (``b0``, ``b1``, ...
by the pattern's kinds: ``attn`` is attention (GQA or MLA) then a SwiGLU
or squared-ReLU MLP or the MoE block; ``ssm`` the Mamba-2 block alone;
``rec`` the RG-LRU block then the MLP), and the ``num_layers %
len(pattern)`` layers left over are the *tail* blocks ``tail/t0``, ...
Parameters keep the JAX package's nested-dict layout and key names,
every unit block weight stacked on a leading *unit* axis ``(U, in, out)``
(an expert stack ``(U, E, in, out)``), tail weights without it; the JAX
``lax.scan`` over units becomes a Python loop over that axis.  Caches are
dicts of tensors updated in place: a unit leaf (U, B, ...), a tail leaf
(B, ...).

Entry points:
  init_params(cfg, seed=, device=)           -> param dict
  params_from_jax(flat_numpy, device=)       -> the same dict from the
                                                JAX package's weights
  init_cache(cfg, batch, capacity, device=)  -> contiguous cache dict
  forward(params, cfg, tokens, ...)          -> (logits, cache)
  lm_loss(params, cfg, tokens, labels, patch_embeds=) -> (loss, parts)

Differentiating ``lm_loss`` with autograd is the training path's
counterpart of ``jax.value_and_grad``: when the unit leaves require grad,
``forward`` unbinds each stacked leaf once (one stack in the backward)
instead of selecting ``v[u]`` per unit, whose backward would zero-fill
a stacked-size gradient per unit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.moe import moe_block

_KINDS = ("attn", "ssm", "rec")


def check_supported(cfg: ModelConfig) -> None:
    """The port runs decoders of attention blocks (GQA or MLA, then a
    SwiGLU or squared-ReLU MLP or the MoE block), Mamba-2 blocks and
    RG-LRU blocks, in any pattern, with RMS norms or LayerNorm, float or
    int8 K/V (MLA caches ignore the flag, as the JAX package's do), and
    the ``"none"``, ``"audio"`` and ``"vision"`` front ends; a sliding
    window on GQA attention only (MLA refuses windows, as the JAX package
    does).  Everything else raises."""
    ported = (bool(cfg.layer_pattern) and all(k in _KINDS for k in cfg.layer_pattern)
              and cfg.mlp_type in ("swiglu", "squared_relu")
              and not (cfg.use_mla and cfg.window)
              and cfg.frontend in ("none", "audio", "vision"))
    if not ported:
        raise NotImplementedError(
            f"{cfg.name}: only attention decoders (GQA or MLA without a window, dense MLP "
            f"or MoE), the recurrent family (Mamba-2, RG-LRU) and the audio and vision "
            f"front-end stubs are ported; see ROADMAP.md, 'the other architectures'")


# ------------------------------------------------------------------- params
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights with the JAX package's distributions (normal /
    sqrt(fan_in) matrices, ``vision_proj`` among them, 0.02-scaled
    embedding, head and float32 router, zero biases, unit norms with a
    zero ``bias`` under LayerNorm; the SSM and RG-LRU leaves as
    ``ssm.init_ssm`` and ``rglru.init_rglru`` say), drawn from a
    ``torch.Generator`` seeded with ``seed`` — the values differ from
    ``jax.random``'s."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt, d = cfg.dtype, cfg.d_model

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    units = {f"b{j}": _init_block(cfg, kind, (cfg.pattern_units,), normal, device)
             for j, kind in enumerate(cfg.layer_pattern)}
    params = {"embed": {"tok": normal((cfg.padded_vocab, d), 0.02)},
              "units": units,
              "final_norm": _init_norm(cfg, (), device),
              "lm_head": normal((d, cfg.padded_vocab), 0.02)}
    if cfg.tail_pattern:
        params["tail"] = {f"t{j}": _init_block(cfg, kind, (), normal, device)
                          for j, kind in enumerate(cfg.tail_pattern)}
    if cfg.frontend == "vision":
        # projector from the (stub) vision encoder's output to d_model
        params["vision_proj"] = normal((d, d), d ** -0.5)
    return params


def _init_norm(cfg: ModelConfig, lead, device) -> Dict[str, torch.Tensor]:
    """Unit ``norm_scale`` and, under LayerNorm, a zero ``bias``, with the
    leading axes ``lead``."""
    shape = (*lead, cfg.d_model)
    p = {"norm_scale": torch.ones(shape, dtype=cfg.dtype, device=device)}
    if cfg.norm_layernorm:
        p["bias"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return p


def _init_block(cfg: ModelConfig, kind: str, lead, normal, device) -> Dict[str, Any]:
    """One block's weights with the leading axes ``lead``: (U,) for a
    unit stack, () for a tail block."""
    dt, d = cfg.dtype, cfg.d_model

    def dense(fan_in, fan_out):
        return normal((*lead, fan_in, fan_out), fan_in ** -0.5)

    def ones(*shape):
        return torch.ones((*lead, *shape), dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    def mlp(ff):
        p = {"w_gate": dense(d, ff)} if cfg.mlp_type == "swiglu" else {}
        p.update(w_up=dense(d, ff), w_down=dense(ff, d))   # squared ReLU: two
        return p

    def norm():
        return _init_norm(cfg, lead, device)

    if kind == "ssm":
        return {"norm1": norm(), "mixer": S.init_ssm(cfg, lead, normal, device)}
    if kind == "rec":
        mixer = R.init_rglru(cfg, lead, normal, device)
        return {"norm1": norm(), "mixer": mixer, "norm2": norm(), "ffn": mlp(cfg.d_ff)}
    h = cfg.num_heads
    if cfg.use_mla:
        nope, rope_d, vd, r = (cfg.qk_nope_dim, cfg.rope_head_dim, cfg.v_head_dim,
                               cfg.kv_lora_rank)
        mixer = {"wq": dense(d, h * (nope + rope_d)), "w_dkv": dense(d, r + rope_d),
                 "w_ukv": dense(r, h * (nope + vd)), "wo": dense(h * vd, d),
                 "ckv_norm": ones(r)}
    else:
        kh, hd = cfg.num_kv_heads, cfg.head_dim
        mixer = {"wq": dense(d, h * hd), "wk": dense(d, kh * hd),
                 "wv": dense(d, kh * hd), "wo": dense(h * hd, d)}
        if cfg.attn_bias:
            mixer.update(bq=zeros(h * hd), bk=zeros(kh * hd), bv=zeros(kh * hd))
    if cfg.num_experts:
        e, ff = cfg.num_experts, cfg.moe_d_ff
        ffn = {"router": normal((*lead, d, e), 0.02, torch.float32),
               "experts": {"w_gate": normal((*lead, e, d, ff), d ** -0.5),
                           "w_up": normal((*lead, e, d, ff), d ** -0.5),
                           "w_down": normal((*lead, e, ff, d), ff ** -0.5)}}
        if cfg.num_shared_experts:
            ffn["shared"] = mlp(ff * cfg.num_shared_experts)
    else:
        ffn = mlp(cfg.d_ff)
    return {"norm1": norm(), "mixer": mixer, "norm2": norm(), "ffn": ffn}


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(flat: Dict[str, Any], *, device) -> Dict[str, Any]:
    """Carry the JAX package's weights across: ``flat`` is
    ``repro.core.pytree_io.flatten_params(params)`` ({'units/b0/mixer/wq':
    ndarray, ...}) or a nested dict of host arrays (``jax.device_get`` of
    any dict tree: an MLP, an optimizer's moments); the result is the
    port's nested dict on ``device`` (no default: the caller names the
    device)."""
    return unflatten({name: _to_tensor(a, device)
                      for name, a in flatten_params(flat).items()})


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device="cuda") -> Dict[str, Any]:
    """Zeroed contiguous caches: ``units`` holds each pattern block's,
    every leaf stacked on the unit axis, ``tail`` each tail block's.  GQA
    ``k``/``v`` (U, B, cap, KH, hd) with ``cap = min(capacity, window)``
    under a sliding window (a ring), MLA ``ckv`` (U, B, cap, r) and
    ``k_rope`` (U, B, cap, rope_d), each with ``len`` (U, B) int32 (GQA
    int8 codes with f32 ``k_scale``/``v_scale`` (U, B, cap, KH, 1) under
    ``kv_cache_int8``);
    Mamba-2 ``conv`` and f32 ``state`` (U, B, H, N, P); RG-LRU ``conv``
    and f32 ``state`` (U, B, W).  A tail leaf has no unit axis."""
    check_supported(cfg)
    units = {f"b{j}": _init_block_cache(cfg, kind, (cfg.pattern_units, batch), capacity,
                                        device)
             for j, kind in enumerate(cfg.layer_pattern)}
    cache: Dict[str, Any] = {"units": units}
    if cfg.tail_pattern:
        cache["tail"] = {f"t{j}": _init_block_cache(cfg, kind, (batch,), capacity, device)
                         for j, kind in enumerate(cfg.tail_pattern)}
    return cache


def _init_block_cache(cfg: ModelConfig, kind: str, lead, capacity: int, device):
    dt = cfg.dtype
    if kind == "ssm":
        return S.init_ssm_cache(cfg, lead, dt, device)
    if kind == "rec":
        return R.init_rglru_cache(cfg, lead, dt, device)
    cap = min(capacity, cfg.window) if cfg.window else capacity
    if cfg.use_mla:
        return L.init_mla_cache(cfg, lead, cap, dt, device)
    return L.init_attn_cache(cfg, lead, cap, dt, device)


# ------------------------------------------------------------------ forward
def _apply_block(p: Dict[str, Any], kind: str, x: torch.Tensor, cfg: ModelConfig, *,
                 cache, pos, attend_cache, chunk_valid, paged_tables,
                 paged_kernel) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Pre-norm residual block.  ``attn``: attention (paged MLA, paged
    GQA, MLA or GQA, the JAX package's dispatch order; paged MLA has no
    kernel route and ignores ``paged_kernel``), then the MoE block or the
    MLP; ``ssm``: the Mamba-2 block alone; ``rec``: the RG-LRU block then
    the MLP.  The recurrent blocks take their lane state as it comes
    (position-free, one row a lane), paged decode or not, and read no
    ``attend_cache``: the gateway never routes models with recurrent
    state through chunked or suffix prefill.  Returns (x, aux loss or
    ``None``, the block's new cache)."""
    h = L.apply_norm(x, p["norm1"], cfg)
    if kind == "ssm":
        y, new_cache = S.ssm_block(p["mixer"], h, cfg, cache=cache)
        return x + y, None, new_cache
    if kind == "rec":
        y, new_cache = R.rglru_block(p["mixer"], h, cfg, cache=cache)
        x = x + y
        h2 = L.apply_norm(x, p["norm2"], cfg)
        return x + L.mlp_block(p["ffn"], h2, cfg), None, new_cache
    if paged_tables is not None and cfg.use_mla:
        y, new_cache = L.mla_block_paged(p["mixer"], h, cfg, cache=cache,
                                         tables=paged_tables, pos=pos)
    elif paged_tables is not None:
        y, new_cache = L.attention_block_paged(
            p["mixer"], h, cfg, cache=cache, tables=paged_tables, pos=pos,
            use_kernel=paged_kernel)
    elif cfg.use_mla:
        y, new_cache = L.mla_block(p["mixer"], h, cfg, cache=cache, pos=pos,
                                   attend_cache=attend_cache, chunk_valid=chunk_valid)
    else:
        y, new_cache = L.attention_block(
            p["mixer"], h, cfg, cache=cache, pos=pos, window=cfg.window,
            attend_cache=attend_cache, chunk_valid=chunk_valid)
    x = x + y.to(x.dtype)
    h2 = L.apply_norm(x, p["norm2"], cfg)
    if cfg.num_experts:
        y2, aux = moe_block(p["ffn"], h2, cfg)
    else:
        y2, aux = L.mlp_block(p["ffn"], h2, cfg), None
    return x + y2.to(x.dtype), aux, new_cache


def _unit(tree: Dict[str, Any], u: int) -> Dict[str, Any]:
    return {k: (_unit(v, u) if isinstance(v, dict) else v[u]) for k, v in tree.items()}


def _unbound_units(tree: Dict[str, Any]):
    """Every unit's leaves, each stacked leaf unbound once, when autograd
    records through them (the training path); ``None`` otherwise."""
    flat = flatten_params(tree)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in flat.values())):
        return None
    parts = {name: t.unbind(0) for name, t in flat.items()}
    return [unflatten({name: p[u] for name, p in parts.items()})
            for u in range(len(next(iter(parts.values()))))]


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: Optional[torch.Tensor], **kw,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, padded_vocab) f32, cache or None); the
    arguments are :func:`forward_aux`'s."""
    logits, _, cache = forward_aux(params, cfg, tokens, **kw)
    return logits, cache


def forward_aux(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor],       # (B, S) int
    *,
    patch_embeds: Optional[torch.Tensor] = None,   # (B, P, D) vision stub output
    cache: Optional[Dict[str, Any]] = None,
    pos=0,
    license_intervals=None,
    attend_cache: bool = False,
    chunk_valid=None,
    paged_tables: Optional[torch.Tensor] = None,
    paged_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, padded_vocab) f32, the MoE aux loss summed
    over units (an f32 scalar; ``None`` without experts), cache or None).

    ``patch_embeds`` (B, P, D), the vision encoder stub's output, is
    projected through ``vision_proj`` (where the params have one), cast
    to ``cfg.dtype`` and prepended to the token embeddings: S counts the
    P patch positions first.

    ``params`` may hold int8 ``{"codes", "scale"}`` leaves
    (``serving/quantized.py``): each unit's, and each tail block's, are
    dequantized with the ``license_intervals`` mask ((lo, hi) f32
    (MAX_INTERVALS,) on the device; ``None`` masks nothing) fused in,
    just before they run, so every license tier shares the one int8
    store.

    ``cache`` leaves are updated in place and the same dict comes back.
    ``attend_cache=True`` is chunked prefill: ``tokens`` continue prompts
    whose positions ``[0, pos)`` are already in ``cache``; ``pos`` may be
    (B,) per lane and ``chunk_valid`` (B,) counts each lane's real rows.

    ``paged_tables`` (B, T) int32 selects kernel-resident paged decode:
    ``cache`` is ``PagedCachePool.decode_cache`` (the pool's physical
    block tensors (U, P+1, bs, ...) plus per-lane ``len`` (U, B) and any
    recurrent lane state), ``pos`` is (B,) int32 and ``tokens`` (B, 1).
    ``paged_kernel`` routes the write and the attention through the
    Hopper kernels; ``False`` is the plain path with the same semantics
    (MLA has the plain path only).
    """
    check_supported(cfg)
    if paged_tables is not None:
        assert cache is not None and not attend_cache
    from repro_torch.serving.quantized import dequant_tree, qleaves

    quantized = next(qleaves(params["units"]), None) is not None
    parts = []
    if patch_embeds is not None:
        proj = params.get("vision_proj")
        pe = (torch.einsum("bpd,df->bpf", patch_embeds, proj) if proj is not None
              else patch_embeds)
        parts.append(pe.to(cfg.dtype))
    if tokens is not None:
        parts.append(params["embed"]["tok"][tokens.long()])
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    unbound = _unbound_units(params["units"])
    aux = None

    def run(p, kind, c):
        nonlocal x, aux
        x, a, nc = _apply_block(p, kind, x, cfg, cache=c, pos=pos, attend_cache=attend_cache,
                                chunk_valid=chunk_valid, paged_tables=paged_tables,
                                paged_kernel=paged_kernel)
        if a is not None:
            aux = a if aux is None else aux + a
        # attention writes K/V in place; every other new leaf is copied in
        for name, t in (nc or {}).items():
            if t is not c[name]:
                c[name].copy_(t)

    for u in range(cfg.pattern_units):
        unit_params = _unit(params["units"], u) if unbound is None else unbound[u]
        if quantized:
            unit_params = dequant_tree(unit_params, license_intervals, cfg.dtype)
        unit_cache = None if cache is None else _unit(cache["units"], u)
        for j, kind in enumerate(cfg.layer_pattern):
            run(unit_params[f"b{j}"], kind, None if unit_cache is None else unit_cache[f"b{j}"])
    for j, kind in enumerate(cfg.tail_pattern):
        tp = params["tail"][f"t{j}"]
        if quantized:
            tp = dequant_tree(tp, license_intervals, cfg.dtype)
        run(tp, kind, None if cache is None else cache["tail"][f"t{j}"])
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = (x @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits, aux, cache


# --------------------------------------------------------------------- loss
def lm_loss(
    params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
    labels: torch.Tensor, *, patch_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM cross-entropy + ``moe_aux_weight`` times the MoE aux
    loss (0 without experts).  labels = next-token ids, with -100 entries
    masked out; they cover the text only, so the logits of a vision
    prefix's P patch positions are dropped first."""
    logits, aux, _ = forward_aux(params, cfg, tokens, patch_embeds=patch_embeds)
    if patch_embeds is not None:
        logits = logits[:, patch_embeds.shape[1]:]
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    total = loss + cfg.moe_aux_weight * aux
    return total, {"lm_loss": loss, "aux_loss": aux}
