"""Neural layers of the port: RMS norm and LayerNorm, RoPE, GQA causal
attention (prefill, decode, chunked ``attend_cache``; linear or, with a
sliding window, a ring cache; float or int8 K/V), the kernel-resident
paged decode attention, DeepSeek-V2's multi-head latent attention (MLA,
contiguous and paged), and the SwiGLU and squared-ReLU MLPs.

Counterpart of ``repro/models/layers.py`` restricted to what the ported
decoders run; numerics follow it step by step (f32 norms and RoPE, q scaled in
its own dtype, f32 scores, ``finfo.min`` masking, probabilities cast to
``v.dtype`` before the value product).  Tensors keep the JAX layouts:
activations (B, S, D), heads (B, S, H, hd), caches (B, cap, KH, hd) and
paged blocks (P+1, bs, KH, hd).  Cache leaves are updated IN PLACE: a
cache handed to a block comes back holding the new tokens.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             bf16_apply: bool = False) -> torch.Tensor:
    """Statistics in f32; applied in f32, or with ``bf16_apply`` in the
    input dtype (the rsqrt cast to it first), as the JAX package does."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    if bf16_apply:
        r = torch.rsqrt(var + eps).to(x.dtype)
        return x * r * scale.to(x.dtype)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics and the population variance
    (``jnp.var``; ``torch.var`` defaults to the unbiased estimate)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg=None) -> torch.Tensor:
    """A block's or the final norm: LayerNorm when ``p`` has a ``bias``,
    else RMS, applied in the input dtype when ``cfg.norm_bf16_apply``."""
    if "bias" in p:
        return layer_norm(x, p["norm_scale"], p["bias"])
    return rms_norm(x, p["norm_scale"],
                    bf16_apply=bool(cfg is not None and cfg.norm_bf16_apply))


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # the fill is a Python scalar: a tensor made on the device would be a
    # host copy, which a CUDA graph capture (the compiled chunk step) refuses
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1)
    # rows with no valid key (padded decode) -> zeros
    any_valid = mask.any(-1, keepdim=True)
    return torch.where(any_valid, probs, torch.zeros_like(probs))


def _scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale with the scale rounded to q's dtype first (the JAX
    package multiplies by ``jnp.asarray(scale, q.dtype)``)."""
    return q * torch.tensor(scale, dtype=q.dtype)


def attention_core(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, KH, hd)
    v: torch.Tensor,              # (B, Sk, KH, hd)
    *,
    q_offset,                     # int or (B,): absolute position of q[:, 0]
    window: int = 0,              # 0 = full causal; > 0 = sliding window
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid cache length (decode)
    k_positions: Optional[torch.Tensor] = None,  # (Sk,) or (B, Sk) key positions
) -> torch.Tensor:
    """Causal (optionally windowed) attention.  Key slot ``i`` holds
    absolute position ``i`` (linear cache / fresh prefill) unless
    ``k_positions`` gives each slot's position (the ring's chunked
    prefill), where a negative position is an empty slot, masked.
    ``kv_len`` bounds the valid slots by index.  The JAX package scans
    query chunks of ``q_chunk`` rows to bound memory at 32k tokens; each
    row's softmax is independent, so one pass over all rows computes the
    same values."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    groups = h // kh
    qg = _scale_q(q, 1.0 / math.sqrt(hd)).reshape(b, sq, kh, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    k_pos = torch.arange(sk, device=q.device)
    kp = (k_pos if k_positions is None else k_positions).reshape(-1, 1, sk)  # (B|1, 1, Sk)
    q_off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)   # (B|1, 1)
    q_pos = (q_off + torch.arange(sq, device=q.device))[:, :, None]     # (B|1, Sq, 1)
    mask = kp <= q_pos                                                   # (B|1, Sq, Sk)
    if k_positions is not None:
        mask = mask & (kp >= 0)
    if window:
        mask = mask & (kp > q_pos - window)
    if kv_len is not None:
        mask = mask & (k_pos[None, None, :] < kv_len.reshape(-1, 1, 1))
    probs = _masked_softmax(scores, mask[:, None, None])
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def _attn_qkv(p: Dict[str, Any], x: torch.Tensor, cfg, positions: torch.Tensor):
    """Shared GQA q/k/v projection + bias + RoPE of the contiguous and the
    paged paths (``positions`` broadcastable to (B, S))."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kh, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kh, hd)


def attention_block(
    p: Dict[str, Any], x: torch.Tensor, cfg, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos=0, window: int = 0, attend_cache: bool = False, chunk_valid=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention over a cache ``k``/``v`` (B, cap, KH, hd) + ``len``
    (B,): linear with ``window == 0``, a ring of ``cap`` slots (position
    ``t`` in slot ``t mod cap``) with a sliding window.

    Modes as in the JAX package: prefill (no cache, or a cache filled
    from empty), decode (S == 1) and, with ``attend_cache=True``, chunked
    prefill: S tokens starting at absolute ``pos`` (an int, or (B,) per
    lane) attend over the updated cache.  On a linear cache chunk writes
    beyond the last slot clamp onto it instead of wrapping, so a lane's
    right-padding rows ("junk", past ``chunk_valid`` real rows) never
    overwrite live prefix slots; they are causally invisible to every
    real query.  On a ring the chunk's own writes may evict positions its
    earliest queries still need, so it attends over a snapshot of the
    ring taken before the writes joined with its own K/V, each slot at
    the absolute position it held (negative: empty), and pad rows write
    back the snapshot's content of their slot.  A prefill of more tokens
    than the ring has slots writes only the last ``cap`` (the rest would
    be evicted by them; duplicate slots in one indexed write have no
    defined winner on CUDA).
    """
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    pos_t = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
    positions = (pos_t + torch.arange(s, device=x.device)).expand(b, s)
    q, k, v = _attn_qkv(p, x, cfg, positions)

    if cache is None:
        out = attention_core(q, k, v, q_offset=pos, window=window)
        new_cache = None
    else:
        quant = "k_scale" in cache
        cap = cache["k"].shape[1]
        ring = bool(window) and attend_cache
        rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
        if ring:
            assert s <= cap, (s, cap)  # one chunk may not lap the ring
            slot = positions % cap
            if quant:
                old_k = _kv_dequantize(cache["k"], cache["k_scale"], k.dtype)
                old_v = _kv_dequantize(cache["v"], cache["v_scale"], v.dtype)
            else:
                old_k, old_v = cache["k"].clone(), cache["v"].clone()
            # the position in slot i before this chunk: the largest
            # t < pos with t mod cap == i (negative = empty)
            last = positions[:, :1] - 1
            old_pos = last - (last - torch.arange(cap, device=x.device)) % cap   # (B, cap)
        elif attend_cache:
            slot = positions.clamp(0, cap - 1)
        else:
            slot = positions % cap
        if quant:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            writes = {"k": k, "v": v}
        if ring and chunk_valid is not None:
            # pad rows write back their slot's resident content (codes and
            # scales as they are on an int8 ring)
            keep = (torch.arange(s, device=x.device)[None, :]
                    < torch.as_tensor(chunk_valid, device=x.device).reshape(-1, 1))
            sel = keep[..., None, None]                            # (B|1, s, 1, 1)
            writes = {n: torch.where(sel, t, cache[n][rows, slot]) for n, t in writes.items()}
        w_rows, w_slot = rows, slot
        if s > cap:                        # the last cap positions, distinct slots
            writes = {n: t[:, -cap:] for n, t in writes.items()}
            w_rows, w_slot = rows[:, -cap:], slot[:, -cap:]
        for n, t in writes.items():
            cache[n][w_rows, w_slot] = t.to(cache[n].dtype)
        cv_n = s if chunk_valid is None else torch.as_tensor(chunk_valid,
                                                              device=x.device)
        new_len = torch.clamp(cache["len"] + cv_n, max=cap).to(cache["len"].dtype)
        if ring:
            # an int8 ring attends the fresh chunk round-tripped through
            # int8, as every other key is seen
            k_att = _kv_dequantize(kq, ks, k.dtype) if quant else k
            v_att = _kv_dequantize(vq, vs, v.dtype) if quant else v
            out = attention_core(q, torch.cat([old_k, k_att], 1), torch.cat([old_v, v_att], 1),
                                 q_offset=pos, window=window,
                                 k_positions=torch.cat([old_pos, positions], 1))
        elif s == 1 or attend_cache:
            # RoPE is applied at each key's absolute position, so the order
            # of a ring's slots does not matter to the scores
            if quant:
                kk = _kv_dequantize(cache["k"], cache["k_scale"], k.dtype)
                vv = _kv_dequantize(cache["v"], cache["v_scale"], v.dtype)
            else:
                kk, vv = cache["k"], cache["v"]
            out = attention_core(q, kk, vv, q_offset=pos,
                                 kv_len=None if attend_cache else new_len)
        else:
            out = attention_core(q, k, v, q_offset=pos, window=window)
        new_cache = {**{n: cache[n] for n in writes}, "len": new_len}
    y = out.reshape(b, s, h * hd) @ p["wo"]
    return y, new_cache


# ---------------------------------------------- kernel-resident paged decode
def gather_paged(blocks: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(P, bs, *rest) physical blocks + (B, T) tables -> (B, T*bs, *rest)."""
    g = blocks[tables.long()]
    s = g.shape
    return g.reshape(s[0], s[1] * s[2], *s[3:])


def paged_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ctx: torch.Tensor) -> torch.Tensor:
    """One-token-per-lane attention over a table-gathered cache — the
    plain path of paged decode.

    q (B, H, hd); k/v (B, S, KH, hd) in logical order with junk past each
    lane's ``ctx`` (B,) valid length (masked).  Mirrors the decode
    numerics of :func:`attention_core`: q scaled in its own dtype, f32
    scores, :func:`_masked_softmax`, probs cast to ``v.dtype``."""
    b, h, hd = q.shape
    kh = k.shape[2]
    groups = h // kh
    qg = _scale_q(q, 1.0 / math.sqrt(hd)).reshape(b, kh, groups, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float())
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < ctx[:, None]
    probs = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v.dtype), v)
    return out.reshape(b, h, v.shape[-1])


def attention_block_paged(
    p: Dict[str, Any], x: torch.Tensor, cfg, *,
    cache: Dict[str, torch.Tensor], tables: torch.Tensor, pos: torch.Tensor,
    use_kernel: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GQA decode straight against the paged pool — no contiguous view.

    ``x`` (B, 1, d), one token per lane; ``cache`` holds this layer's
    physical block pools ``k``/``v`` (P+1, bs, KH, hd), shared by every
    lane, and the per-lane ``len`` (B,); ``tables`` (B, T) int32 names
    each lane's blocks in logical order; ``pos`` (B,) int32 absolute
    positions.  The new K/V token is written in place through
    ``(tables[b, pos // bs], pos % bs)``.

    ``use_kernel=True`` writes and attends through the Hopper kernels
    (their wrappers take the plain versions for CPU tensors); the kernel
    returns f32, cast to ``x.dtype``.  ``use_kernel=False`` is the plain
    path: an indexed write, a table gather and :func:`paged_decode_attend`.
    """
    b, s, _ = x.shape
    assert s == 1, s
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _attn_qkv(p, x, cfg, pos[:, None])
    kc, vc = cache["k"], cache["v"]
    bs = kc.shape[1]
    blk = torch.gather(tables, 1, (pos // bs)[:, None].long())[:, 0]
    off = (pos % bs).to(torch.int32)
    quant = "k_scale" in cache
    if quant and use_kernel:
        raise ValueError("attention_block_paged: the paged kernels read float K/V; an int8 "
                         "cache takes use_kernel=False")
    if quant:
        kq, ks = _kv_quantize(k[:, 0])
        vq, vs = _kv_quantize(v[:, 0])
        for n, t in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            cache[n][blk.long(), off.long()] = t
        kk = _kv_dequantize(gather_paged(kc, tables), gather_paged(cache["k_scale"], tables),
                            k.dtype)
        vv = _kv_dequantize(gather_paged(vc, tables), gather_paged(cache["v_scale"], tables),
                            v.dtype)
        out = paged_decode_attend(q[:, 0], kk, vv, pos + 1)
    elif use_kernel:
        from repro_torch.kernels.paged_attention import (paged_attention,
                                                         paged_decode_write)

        paged_decode_write(kc, vc, k[:, 0], v[:, 0], blk, off)
        out = paged_attention(q[:, 0], kc, vc, tables,
                              (pos + 1).to(torch.int32)).to(x.dtype)
    else:
        from repro_torch.kernels import ref

        ref.paged_decode_write(kc, vc, k[:, 0], v[:, 0], blk, off)
        out = paged_decode_attend(q[:, 0], gather_paged(kc, tables),
                                  gather_paged(vc, tables), pos + 1)
    # len + 1 never clamps here: the gateway admits pos < capacity only
    new_cache = {**cache, "len": cache["len"] + 1}
    y = out.reshape(b, 1, h * hd) @ p["wo"]
    return y, new_cache


def init_attn_cache(cfg, batch, capacity: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed GQA cache; ``batch`` is an int or a tuple of leading axes
    (the model's (units, batch)).  With ``cfg.kv_cache_int8`` the ``k``/
    ``v`` leaves are int8 codes with f32 ``k_scale``/``v_scale`` (..., cap,
    KH, 1), one scale a (token, head)."""
    lead = tuple(batch) if isinstance(batch, tuple) else (batch,)
    shape = (*lead, capacity, cfg.num_kv_heads, cfg.head_dim)
    cache = {"len": torch.zeros(lead, dtype=torch.int32, device=device)}
    if cfg.kv_cache_int8:
        for n in ("k", "v"):
            cache[n] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{n}_scale"] = torch.zeros((*shape[:-1], 1), dtype=torch.float32,
                                              device=device)
    else:
        cache.update(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes and (..., 1) f32 scales: symmetric absmax
    over the head dim, scale 1 on a zero row, ``torch.round`` half to
    even as ``jnp.round``.  The divisor 127 is a device tensor: CUDA
    computes a division by a host scalar as a product with its
    reciprocal, which would move scales by an ulp."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    codes = torch.clamp(torch.round(x32 / scale), -127, 127)
    return codes.to(torch.int8), scale


def _kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


# ------------------------------------------------------------ MLA attention
def _mla_qkv(p: Dict[str, Any], x: torch.Tensor, cfg, positions: torch.Tensor):
    """Shared MLA projection front end (query, compressed KV, rotary key)
    of the contiguous and paged paths: q_nope (B, S, H, nope), q_rope
    (B, S, H, rope_d), c_kv (B, S, r) RMS-normed, k_rope (B, S, 1,
    rope_d); ``positions`` broadcastable to (B, S)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rope_d, r = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q = (x @ p["wq"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = x @ p["w_dkv"]                                      # (B, S, r + rope_d)
    c_kv = rms_norm(dkv[..., :r], p["ckv_norm"])
    k_rope = dkv[..., r:][:, :, None, :]                      # (B, S, 1, rope_d)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_kv(p: Dict[str, Any], c_kv: torch.Tensor, k_rope: torch.Tensor, cfg):
    """Decompress (B, S, r) latents and (B, S, 1, rope_d) rotary keys into
    per-head keys (B, S, H, nope + rope_d) and values (B, S, H, vd)."""
    b, sk, _ = c_kv.shape
    h, nope, vd = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    ukv = (c_kv @ p["w_ukv"]).reshape(b, sk, h, nope + vd)
    k_nope, v = ukv[..., :nope], ukv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, sk, h, k_rope.shape[-1])], dim=-1)
    return k, v


def mla_block(
    p: Dict[str, Any], x: torch.Tensor, cfg, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos=0, attend_cache: bool = False, chunk_valid=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention (DeepSeek-V2).  The cache holds the
    compressed ``ckv`` (B, cap, r) and the shared rotary key ``k_rope``
    (B, cap, rope_d) + ``len`` (B,); every step decompresses what it
    attends over with ``w_ukv``.

    Modes as :func:`attention_block`'s: prefill, decode with the cache's
    ``len`` and chunked prefill (``attend_cache``), whose writes past the
    last slot clamp onto it.  With a cache, queries attend over the whole
    updated cache (causal masking bounds them).  The softmax scale is
    1/sqrt(nope + rope_d), q's head dim, as in the JAX package."""
    b, s, _ = x.shape
    h, vd = cfg.num_heads, cfg.v_head_dim
    pos_t = torch.as_tensor(pos, device=x.device).reshape(-1, 1)
    positions = (pos_t + torch.arange(s, device=x.device)).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)

    if cache is not None:
        cap = cache["ckv"].shape[1]
        slot = positions.clamp(0, cap - 1) if attend_cache else positions % cap
        rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
        c_all, kr_all = cache["ckv"], cache["k_rope"]
        c_all[rows, slot] = c_kv.to(c_all.dtype)
        kr_all[rows, slot] = k_rope[:, :, 0].to(kr_all.dtype)
        cv_n = s if chunk_valid is None else torch.as_tensor(chunk_valid,
                                                              device=x.device)
        new_len = torch.clamp(cache["len"] + cv_n, max=cap).to(cache["len"].dtype)
        new_cache = {"ckv": c_all, "k_rope": kr_all, "len": new_len}
        kv_src, kr_src = c_all, kr_all[:, :, None, :]
        kv_len = None if attend_cache else new_len
    else:
        new_cache = None
        kv_src, kr_src, kv_len = c_kv, k_rope, None

    k, v = _mla_kv(p, kv_src, kr_src, cfg)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_core(qfull, k, v, q_offset=pos,
                         kv_len=kv_len if s == 1 else None)
    y = out.reshape(b, s, h * vd) @ p["wo"]
    return y, new_cache


def mla_block_paged(
    p: Dict[str, Any], x: torch.Tensor, cfg, *,
    cache: Dict[str, torch.Tensor], tables: torch.Tensor, pos: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLA decode against paged compressed-KV blocks, the contract of
    :func:`attention_block_paged`: ``cache`` holds this layer's block
    pools ``ckv`` (P+1, bs, r) and ``k_rope`` (P+1, bs, rope_d) and the
    lanes' ``len``; the token's latent and rotary key are written in
    place through ``(tables[b, pos // bs], pos % bs)``, each lane's chain
    is gathered once and decompressed, and :func:`paged_decode_attend`
    attends over it.  The JAX package runs this without a Pallas kernel,
    so there is no kernel route: plain PyTorch on every device."""
    b, s, _ = x.shape
    assert s == 1, s
    h, vd = cfg.num_heads, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, pos[:, None])
    ckv_blocks, kr_blocks = cache["ckv"], cache["k_rope"]
    bs = ckv_blocks.shape[1]
    blk = torch.gather(tables, 1, (pos // bs)[:, None].long())[:, 0].long()
    off = (pos % bs).long()
    ckv_blocks[blk, off] = c_kv[:, 0].to(ckv_blocks.dtype)
    kr_blocks[blk, off] = k_rope[:, 0, 0].to(kr_blocks.dtype)
    k, v = _mla_kv(p, gather_paged(ckv_blocks, tables),
                   gather_paged(kr_blocks, tables)[:, :, None, :], cfg)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = paged_decode_attend(qfull[:, 0], k, v, pos + 1)
    new_cache = {"ckv": ckv_blocks, "k_rope": kr_blocks, "len": cache["len"] + 1}
    y = out.reshape(b, 1, h * vd) @ p["wo"]
    return y, new_cache


def init_mla_cache(cfg, batch, capacity: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed MLA cache; ``batch`` is an int or a tuple of leading axes
    (the model's (units, batch))."""
    lead = tuple(batch) if isinstance(batch, tuple) else (batch,)
    return {
        "ckv": torch.zeros((*lead, capacity, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, capacity, cfg.rope_head_dim), dtype=dtype,
                              device=device),
        "len": torch.zeros(lead, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------- MLPs
def mlp_block(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU when the block has ``w_gate``, else the nemotron family's
    squared ReLU, ``relu(x @ w_up) ** 2`` as ``r * r`` in the activation
    dtype."""
    u = x @ p["w_up"]
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * u
    else:
        r = F.relu(u)
        h = r * r
    return h @ p["w_down"]
