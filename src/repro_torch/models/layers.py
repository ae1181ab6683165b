"""Neural layers of the port: RMS norm and LayerNorm, RoPE, GQA causal
attention (prefill, decode, chunked ``attend_cache``; linear or, with a
sliding window, a ring cache; float or int8 K/V), the kernel-resident
paged decode attention, DeepSeek-V2's multi-head latent attention (MLA:
contiguous, linear or under a sliding window a latent ring, and paged),
and the SwiGLU and squared-ReLU MLPs.

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
import numbers
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distribution.sharding import axis_sizes, on_mesh, placements, shard_offsets


# ------------------------------------------------------------------ the mesh
def hint_sharding(x: torch.Tensor, *spec) -> torch.Tensor:
    """Pin a ``DTensor``'s placements; identity on a plain tensor.

    Model code stays mesh-agnostic: under a mesh the hint redistributes
    ``x`` to the spec's placements (one entry per tensor dim, an axis
    name, a tuple of them or ``None``, as in
    ``distribution.sharding``); off the mesh it returns ``x`` itself, so
    the plain path runs the same ops.  The sentinel ``"batch"`` resolves
    to ("pod", "data") when the mesh has a pod axis, else ("data",).  A
    spec naming an axis the mesh lacks leaves ``x`` as it is.  Where the
    axes named on a dim do not divide it (a batch of 1 over 16 data
    ranks), the dim stays whole: GSPMD pads such a shard, DTensor's views
    cannot split an uneven one.  A ``DTensor`` is redistributed even to
    the placements it has: that step's backward hands the gradient on in
    a layout DTensor's einsum backward can view (deepseek-moe-16b's
    expert products at train_4k fail without it)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    batch = ("pod", "data") if "pod" in sizes else ("data",)
    resolved = []
    for dim, e in enumerate(batch if s == "batch" else s for s in spec):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        if any(a not in sizes for a in axes):
            return x
        n = 1
        for a in axes:
            n *= sizes[a]
        resolved.append(axes if x.shape[dim] % n == 0 else ())
    return x.redistribute(mesh, on_mesh(placements(resolved, mesh), mesh))


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on every rank and no pending sum (a
    ``DTensor``'s shards of other dims kept); identity on a plain
    tensor."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pls = tuple(Replicate() if p.is_shard(dim) or p.is_partial() else p
                for p in x.placements)
    return x if pls == tuple(x.placements) else x.redistribute(x.device_mesh, pls)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations (B, ..., K) and a weight (K, N).

    Off the mesh it is ``x @ w`` itself.  Under a mesh the product runs
    on the flattened rows, and where DTensor shards those rows over mesh
    axes whose sizes do not divide B (a prefill of 4 rows on 16 data
    ranks), they are made whole before the rows are unflattened:
    DTensor cannot unflatten such a shard, where GSPMD pads it.  The
    values are the product's either way.  ``launch.op_cost`` keys the
    product by this function's caller."""
    if not isinstance(x, DTensor) or x.ndim < 3:
        return x @ w
    rows = x.reshape(-1, x.shape[-1])
    # redistributed to its own layout: the backward hands the rows'
    # gradient on in it, which unflattens
    y = rows.redistribute(rows.device_mesh, rows.placements) @ w
    mesh = y.device_mesh
    split = [i for i, p in enumerate(y.placements) if type(p) is Shard and p.dim == 0]
    if x.shape[0] % math.prod(mesh.size(i) for i in split):
        y = y.redistribute(mesh, tuple(Replicate() if i in split else p
                                       for i, p in enumerate(y.placements)))
    return y.reshape(*x.shape[:-1], y.shape[-1])


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., heads * d) -> (..., heads, d).  Under a mesh whose shards of
    the last dim do not divide the heads (a smoke model's 4 heads over 16
    ranks), the dim is first made whole: DTensor cannot split it."""
    if heads % _head_shards(x, x.ndim - 1):
        x = unshard(x, -1)
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)


def split_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """(B, ...) -> (m, B / m, ...): row block i of ``m``.  Under a mesh
    that shards B over ranks whose count ``m`` does not divide (256 rows
    in 4 micro-batches on 16 data ranks), the rows are first made whole:
    DTensor cannot unflatten such a shard, where GSPMD moves the rows
    with an all-to-all."""
    if m % _head_shards(x, 0):
        x = unshard(x, 0)
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def merge_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., heads, d) -> (..., heads * d), the input of the product with
    ``w``.  Under a mesh the merged dim is placed as ``w``'s contraction
    dim already: DTensor would do that inside the product, and the
    backward of its own move cannot split the gradient back into heads
    that do not divide over the ranks."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not (isinstance(y, DTensor) and isinstance(w, DTensor)):
        return y
    pls = on_mesh(tuple(Shard(y.ndim - 1) if pw.is_shard(w.ndim - 2) else py
                        for py, pw in zip(y.placements, w.placements)), y.device_mesh)
    return y if pls == tuple(y.placements) else y.redistribute(y.device_mesh, pls)


def _head_shards(x: torch.Tensor, dim: int = 2) -> int:
    """How many ranks share ``x``'s dim ``dim`` (1 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if p.is_shard(dim):
            n *= size
    return n


def write_at(leaf: torch.Tensor, index: Tuple[torch.Tensor, ...], value: torch.Tensor) -> None:
    """``leaf[index] = value`` in place, ``index`` a tuple of integer
    tensors over the leaf's leading dims (a cache's lanes and slots).

    A ``DTensor`` leaf (under a mesh) is written shard by shard: DTensor
    has no in-place scatter that keeps a sharded leaf's placements, and
    its out-of-place one gathers the whole leaf.  Each rank takes the
    indices and the values whole on the mesh dims that shard an indexed
    dim (as the leaf's on the others) and writes only the entries that
    fall in its own shard (:func:`write_local`).  A ``meta`` leaf (the
    dry run) has no data to pick those by: every value is written at its
    place clamped into the shard, which costs what the real write does."""
    if not isinstance(leaf, DTensor):
        leaf[index] = value
        return
    mesh, pls, n = leaf.device_mesh, leaf.placements, len(index)
    idx = torch.broadcast_tensors(*(i.full_tensor() if isinstance(i, DTensor) else i
                                    for i in index))
    v_pls = on_mesh(tuple(Shard(p.dim - n + idx[0].ndim) if p.is_shard() and p.dim >= n
                          else Replicate() for p in pls), mesh)
    local, vals = leaf.to_local(), value.redistribute(mesh, v_pls).to_local()
    if local.shape[:n] == leaf.shape[:n]:        # no indexed dim is split
        local[idx] = vals
        return
    offsets = shard_offsets(leaf)[:n]
    if local.is_meta:
        local[tuple((i - o).clamp(0, size - 1)
                    for i, o, size in zip(idx, offsets, local.shape))] = vals
        return
    write_local(local, idx, offsets, vals)


def write_local(local: torch.Tensor, idx: Tuple[torch.Tensor, ...], offsets: Tuple[int, ...],
                vals: torch.Tensor) -> None:
    """Write into ``local``, the shard that starts at ``offsets`` of the
    indexed dims, the entries of ``vals`` whose indices ``idx`` (each of
    ``vals``' leading shape) fall in it; the others are dropped.

    Static shapes and no host synchronization, so a CUDA graph captures
    it: every entry is written, a miss to the slot of the last entry that
    hits, with that entry's value.  The boolean selection leaves the last
    hit's value there too, so the shard holds the same bits (an
    ``index_put_`` whose duplicate destinations carry different values
    leaves any of them on CUDA; a miss clamped onto a slot of its own
    could overwrite a hit).  Where no entry hits, every entry writes the
    value already resident at the first entry's clamped slot."""
    lead = idx[0].shape
    k = idx[0].numel()
    hit = torch.ones(lead, dtype=torch.bool, device=local.device)
    for i, o, size in zip(idx, offsets, local.shape):
        hit &= (i >= o) & (i < o + size)
    hit = hit.reshape(k)
    order = torch.arange(k, device=local.device)
    last = torch.where(hit, order, -1).amax()
    src = torch.where(hit, order, last.clamp(min=0))    # whose slot and value
    dest = tuple((i.reshape(k) - o).clamp(0, size - 1)[src]
                 for i, o, size in zip(idx, offsets, local.shape))
    vals = vals.reshape(k, *vals.shape[len(lead):])
    keep = (last >= 0).reshape((1,) * vals.ndim)
    local[dest] = torch.where(keep, vals[src], local[dest])


def index_add_rows(buf: torch.Tensor, index: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``buf.index_add_(0, index, vals)``, returned.  Under a mesh
    (``vals`` a ``DTensor``) the add is out of place: DTensor's dispatch
    refuses to add its values into a plain buffer in place.  Both give
    the same bits."""
    if isinstance(vals, DTensor):
        return buf.index_add(0, index, vals)
    return buf.index_add_(0, index, vals)


def fill_last_from(x: torch.Tensor, start: int, value: float) -> torch.Tensor:
    """``x[..., start:] = value``, returned.  A ``DTensor`` (vocab-sharded
    logits under a mesh) is filled by ``masked_fill`` instead: DTensor has
    no in-place fill of a slice of a sharded dim.  Both give the same
    bits."""
    if isinstance(x, DTensor):
        return x.masked_fill(torch.arange(x.shape[-1], device=x.device) >= start, value)
    x[..., start:] = value
    return x


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
    (``jnp.var``; ``torch.var`` defaults to the unbiased estimate).  On a
    ``DTensor`` both are sums over the last dim divided by its size:
    DTensor carries a mean's gradient as a ``P(avg)`` partial, which it
    cannot redistribute where it meets the ``P(sum)`` partials of the
    products around it."""
    x32 = x.float()
    if isinstance(x32, DTensor):
        n = x32.shape[-1]
        mu = x32.sum(-1, keepdim=True) / n
        var = ((x32 - mu) * (x32 - mu)).sum(-1, keepdim=True) / n
    else:
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


def device_offset(pos, device) -> torch.Tensor:
    """``pos`` (an int, or (B,) per lane) on ``device``: an int is filled
    there, not copied from the host, so a step that passes one (the
    bucket prefill's 0) stays capturable in a CUDA graph."""
    if isinstance(pos, numbers.Integral):
        return torch.full((), int(pos), dtype=torch.int64, device=device)
    return torch.as_tensor(pos, device=device)


def _no_partial(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s pending sums reduced (``Replicate()`` there);
    identity on a plain tensor.  Attention multiplies q by k and the
    probabilities by v: a product of two pending sums is not the sum of
    the ranks' products, yet DTensor's einsum keeps the sum pending (at
    16 x 16, where a vocab-sharded embedding leaves the activations
    partial and 8 kv heads stay whole, its backward then fails to view
    the gradient)."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in x.placements))


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
    q, k, v = (_no_partial(t) for t in (q, k, v))
    if groups > 1 and kh % _head_shards(q):
        # under a mesh whose head shards do not divide the kv heads (e.g. 16
        # ranks, 2 kv heads): DTensor cannot split a sharded head dim into
        # (kv, group), so each query head gets its own copy of its kv head
        k, v = k.repeat_interleave(groups, dim=2), v.repeat_interleave(groups, dim=2)
        kh, groups = h, 1
    qg = _scale_q(q, 1.0 / math.sqrt(hd)).reshape(b, sq, kh, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    k_pos = torch.arange(sk, device=q.device)
    kp = (k_pos if k_positions is None else k_positions).reshape(-1, 1, sk)  # (B|1, 1, Sk)
    q_off = device_offset(q_offset, q.device).reshape(-1, 1)             # (B|1, 1)
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
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(split_heads(q, h), positions, cfg.rope_theta)
    k = apply_rope(split_heads(k, kh), positions, cfg.rope_theta)
    return q, k, split_heads(v, kh)


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
    pos_t = device_offset(pos, x.device).reshape(-1, 1)
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
            write_at(cache[n], (w_rows, w_slot), t.to(cache[n].dtype))
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
    y = matmul(merge_heads(out, p["wo"]), p["wo"])
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
    q = split_heads(matmul(x, p["wq"]), h)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = matmul(x, p["w_dkv"])                               # (B, S, r + rope_d)
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
    ukv = split_heads(matmul(c_kv, p["w_ukv"]), h)
    k_nope, v = ukv[..., :nope], ukv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, sk, h, k_rope.shape[-1])], dim=-1)
    return k, v


def mla_block(
    p: Dict[str, Any], x: torch.Tensor, cfg, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos=0, window: int = 0, attend_cache: bool = False, chunk_valid=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention (DeepSeek-V2).  The cache holds the
    compressed ``ckv`` (B, cap, r) and the shared rotary key ``k_rope``
    (B, cap, rope_d) + ``len`` (B,); every step decompresses what it
    attends over with ``w_ukv``.

    Modes as :func:`attention_block`'s: prefill, decode with the cache's
    ``len`` and chunked prefill (``attend_cache``), whose writes past the
    last slot clamp onto it.  Without a window, queries attend over the
    whole updated cache (causal masking bounds them).

    With a sliding window the cache is a latent ring by the rule of
    :func:`attention_block`: ``cap`` slots (``init_cache`` sizes it
    ``min(capacity, window)``), position ``t`` in slot ``t mod cap``.  A
    prefill attends over its own fresh latents under the window and, when
    it is longer than the ring, writes only its last ``cap`` positions;
    decode attends over the ring's ``len`` valid slots, which hold the
    window.  Chunked prefill on a windowed cache is refused, as in the
    JAX package.  (The JAX package's windowed decode masks the ring by
    slot index, so from position cap + window - 1 on it masks every slot
    and returns zeros; that is not copied.)

    The softmax scale is 1/sqrt(nope + rope_d), q's head dim, as in the
    JAX package."""
    b, s, _ = x.shape
    h, vd = cfg.num_heads, cfg.v_head_dim
    pos_t = device_offset(pos, x.device).reshape(-1, 1)
    positions = (pos_t + torch.arange(s, device=x.device)).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)

    attend_window = window
    if cache is not None:
        if attend_cache and window:
            raise NotImplementedError("windowed MLA chunked prefill is unsupported "
                                      "(as in the JAX package)")
        cap = cache["ckv"].shape[1]
        slot = positions.clamp(0, cap - 1) if attend_cache else positions % cap
        rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
        c_all, kr_all = cache["ckv"], cache["k_rope"]
        c_w, kr_w = c_kv, k_rope[:, :, 0]
        if s > cap:                        # the last cap positions, distinct slots
            c_w, kr_w = c_w[:, -cap:], kr_w[:, -cap:]
            rows, slot = rows[:, -cap:], slot[:, -cap:]
        write_at(c_all, (rows, slot), c_w.to(c_all.dtype))
        write_at(kr_all, (rows, slot), kr_w.to(kr_all.dtype))
        cv_n = s if chunk_valid is None else torch.as_tensor(chunk_valid,
                                                              device=x.device)
        new_len = torch.clamp(cache["len"] + cv_n, max=cap).to(cache["len"].dtype)
        new_cache = {"ckv": c_all, "k_rope": kr_all, "len": new_len}
        if window and s > 1:               # a ring's prefill: its own latents
            kv_src, kr_src, kv_len = c_kv, k_rope, None
        else:                              # decode over a ring's valid slots (the window)
            kv_src, kr_src = c_all, kr_all[:, :, None, :]
            kv_len = None if attend_cache else new_len
            attend_window = 0
    else:
        new_cache = None
        kv_src, kr_src, kv_len = c_kv, k_rope, None

    k, v = _mla_kv(p, kv_src, kr_src, cfg)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_core(qfull, k, v, q_offset=pos, window=attend_window,
                         kv_len=kv_len if s == 1 else None)
    y = matmul(merge_heads(out, p["wo"]), p["wo"])
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
    u = matmul(x, p["w_up"])
    if "w_gate" in p:
        h = F.silu(matmul(x, p["w_gate"])) * u
    else:
        r = F.relu(u)
        h = r * r
    return matmul(h, p["w_down"])
