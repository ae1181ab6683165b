"""Mamba-2 block of the port (SSD, state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked SSD
form: within a chunk an attention-like quadratic term, across chunks a
linear recurrence of the (H, N, P) state, so no S x S matrix is built
and the decode state is O(1) in sequence length.  The JAX ``lax.scan``
over chunks becomes a Python loop over chunks, in f32.  Decode (one
token with a cache) is the single-step recurrence.  The JAX package
runs this without a Pallas kernel, so there is no kernel route: plain
PyTorch on every device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state   # x plus B and C (one group)


def init_ssm(cfg, lead: Tuple[int, ...], normal: Callable, device) -> Dict[str, Any]:
    """Random block weights with the JAX package's distributions, each
    with the leading axes ``lead`` ((U,) for a unit stack, () for a tail
    block): ``normal(shape, scale, dtype)`` draws the matrices and the
    conv taps; ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` 0 and
    ``D_skip`` 1 in f32; the conv bias 0 and the gate norm 1."""
    d, dt = cfg.d_model, cfg.dtype
    di, h, n, k = d_inner(cfg), n_heads(cfg), cfg.ssm_state, cfg.ssm_conv
    f32 = torch.float32

    def full(value, size, dtype):
        return torch.full((*lead, size), value, dtype=dtype, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device))
    return {
        "in_proj": normal((*lead, d, 2 * di + 2 * n + h), d ** -0.5, dt),  # z, x, B, C, dt
        "conv_w": normal((*lead, k, conv_dim(cfg)), k ** -0.5, dt),
        "conv_b": full(0.0, conv_dim(cfg), dt),
        "A_log": a_log.expand(*lead, h).clone(),
        "dt_bias": full(0.0, h, f32),
        "D_skip": full(1.0, h, f32),
        "gate_norm": full(1.0, di, dt),
        "out_proj": normal((*lead, di, d), di ** -0.5, dt),
    }


def _split_proj(cfg, proj: torch.Tensor):
    """in_proj's output -> (z, xBC, dt) in that order."""
    di, n = d_inner(cfg), cfg.ssm_state
    return proj[..., :di], proj[..., di: 2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d: x (B, L, C), taps w (K, C), bias b (C,),
    ``state`` the last K-1 inputs before x (zeros when ``None``).  The
    taps are summed in x's dtype in tap order, as the JAX package's
    ``sum`` does.  Returns (out + b, the new state: the last K-1 inputs)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    padded = torch.cat([state.to(x.dtype), x], dim=1)              # (B, L+K-1, C)
    length = x.shape[1]
    out = padded[:, :length] * w[0]
    for i in range(1, k):
        out = out + padded[:, i: i + length] * w[i]
    return out + b, padded[:, -(k - 1):]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
                cm: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B, L, H, P) unscaled input, dt (B, L, H) the
    softplus'd step, a (H,) negative, bm / cm (B, L, N), L a multiple of
    ``chunk``, ``init_state`` (B, H, N, P) or ``None``.  Returns (y (B,
    L, H, P) in x's dtype, final state (B, H, N, P) f32)."""
    b, length, h, p = x.shape
    n = bm.shape[-1]
    assert length % chunk == 0, (length, chunk)
    nc = length // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, chunk, h, p)
    dtc = dt.to(f32).reshape(b, nc, chunk, h)
    bc = bm.to(f32).reshape(b, nc, chunk, n)
    cc = cm.to(f32).reshape(b, nc, chunk, n)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    s = (torch.zeros((b, h, n, p), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    ys = []
    for c in range(nc):
        xci, dtci, bci, cci = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        cum_a = torch.cumsum(dtci * a, dim=1)                      # (B, Q, H) <= 0
        total_a = cum_a[:, -1]                                     # (B, H)
        xdt = xci * dtci[..., None]
        # within the chunk: exp(cum_a[i] - cum_a[j]) for i >= j.  Mask
        # BEFORE exp: above the diagonal the difference is positive and
        # explodes, and where(mask, inf, 0) back-propagates 0 * inf = NaN
        diff = cum_a[:, :, None, :] - cum_a[:, None, :, :]         # (B, Q, Q, H)
        decay = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))
        scores = torch.einsum("bin,bjn->bij", cci, bci)
        y = torch.einsum("bij,bijh,bjhp->bihp", scores, decay, xdt)
        # the entering state's contribution
        y = y + torch.einsum("bin,bih,bhnp->bihp", cci, torch.exp(cum_a), s)
        # S' = exp(total_a) S + sum_j exp(total_a - cum_a[j]) B_j (x) xdt_j
        w_state = torch.exp(total_a[:, None, :] - cum_a)           # (B, Q, H)
        s = (s * torch.exp(total_a)[:, :, None, None]
             + torch.einsum("bjn,bjh,bjhp->bhnp", bci, w_state, xdt))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, length, h, p)
    return y.to(x.dtype), s


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), without
    ``F.softplus``'s switch to the identity above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_block(p: Dict[str, Any], xin: torch.Tensor, cfg, *,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba-2 block: in_proj -> causal conv (SiLU) -> SSD -> D skip ->
    SiLU(z)-gated RMS norm -> out_proj.  ``cache`` holds ``conv`` (B,
    K-1, C) in the model dtype and ``state`` (B, H, N, P) f32; one token
    with a cache takes the single-step recurrence, anything else the
    chunked scan from the cache's state (zeros without one), zero-padded
    to a chunk multiple (exact: dt = 0 adds nothing and decays nothing).
    Returns (out, the new cache as new tensors, or ``None``)."""
    b, length, _ = xin.shape
    di, h, n, pd = d_inner(cfg), n_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc, dt_raw = _split_proj(cfg, xin @ p["in_proj"])
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"],
                                None if cache is None else cache["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, length, h, pd)
    bm, cm = xbc[..., di: di + n], xbc[..., di + n:]
    dt = softplus(dt_raw.to(f32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    if length == 1 and cache is not None:
        s_prev = cache["state"].to(f32)                            # (B, H, N, P)
        decay = torch.exp(dt[:, 0] * a)                            # (B, H)
        upd = torch.einsum("bn,bh,bhp->bhnp", bm[:, 0].to(f32), dt[:, 0],
                           xs[:, 0].to(f32))
        final = s_prev * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cm[:, 0].to(f32), final)[:, None]
    else:
        init = None if cache is None else cache["state"]
        chunk = min(cfg.ssm_chunk, length)
        pad = (-length) % chunk
        if pad:
            y, final = ssd_chunked(F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                                   a, F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad)),
                                   chunk, init)
            y = y[:, :length]
        else:
            y, final = ssd_chunked(xs, dt, a, bm, cm, chunk, init)

    y = y + xs.to(f32) * p["D_skip"][:, None]
    y = y.reshape(b, length, di).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    out = y @ p["out_proj"]
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "state": final.to(cache["state"].dtype)}
    return out, new_cache


def init_ssm_cache(cfg, lead: Tuple[int, ...], dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed cache with leading axes ``lead`` (the model's (units,
    batch), or (batch,) for a tail block): ``conv`` (*lead, K-1, C) in
    ``dtype`` and the f32 ``state`` (*lead, H, N, P)."""
    return {
        "conv": torch.zeros((*lead, cfg.ssm_conv - 1, conv_dim(cfg)), dtype=dtype,
                            device=device),
        "state": torch.zeros((*lead, n_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }
