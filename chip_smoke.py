"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in this checkout (``src/repro_torch/kernels``);
2. every kernel of the main path against its plain PyTorch version, on
   the card, at the shapes the gateway gives it, with its time (CUDA
   events), the plain version's time and its bound on this card;
3. the main path: ``LicensedGateway`` serving requests in two license
   tiers at the full width and depth of qwen2.5-3b (random bf16 weights
   from a seed), through float views and through int8 views built by the
   fused masked-dequant; the launch counters are zeroed just before and
   read just after, and every kernel must have run;
4. one decode step's logits through the kernels vs the plain path on the
   same pool state, and the greedy-token agreement of a whole plain-path
   run (for information);
5. a ``kernels`` JSON line, and the result line last.

Imports nothing of JAX.  Exits non-zero without a result when no CUDA
device is present or when run outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "qwen2.5-3b"
FREE_TIER = {"*": ((0.0, 0.01),)}

# published peaks (NVIDIA data sheets, SXM parts): HBM bytes/s, f32 FLOP/s
# outside the tensor cores — the rate the kernels' f32 arithmetic runs at
CARD_PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bound_ms(nbytes: float, flops: float, peaks) -> tuple:
    """Least time for the work on this card: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def check_kernels(peaks, torch, ops, ref, kernels_pa, kernels_md):
    """Each kernel vs its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rows = {}

    # paged_attention: a decode step of 8 lanes, 16 heads over 2 kv heads,
    # head_dim 128, 16-token blocks, ragged contexts up to ~600 tokens
    b, h, kh, hd, bs = 8, 16, 2, 128, 16
    ctx = torch.tensor([1, 17, 100, 255, 311, 480, 555, 600], dtype=torch.int32)
    t_cols = int((ctx.max() + bs - 1) // bs)
    p = b * t_cols + 1
    tables = torch.randperm(p - 1, generator=gen)[: b * t_cols].reshape(b, t_cols)
    for i, n in enumerate(ctx.tolist()):           # dead entries -> null block
        tables[i, -(-n // bs):] = p - 1
    tables, lens = tables.int().to(dev), ctx.to(dev)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5)):
        # both versions compute in f32 from the same (upcast) inputs; only
        # the summation order differs, over <= 600 keys
        q = torch.randn(b, h, hd, generator=gen).to(dtype).to(dev)
        kb = torch.randn(p, bs, kh, hd, generator=gen).to(dtype).to(dev)
        vb = torch.randn(p, bs, kh, hd, generator=gen).to(dtype).to(dev)
        got = kernels_pa.paged_attention(q, kb, vb, tables, lens)
        want = ref.paged_attention(q, kb, vb, tables, lens)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[str(dtype)] = err
        log(f"  paged_attention {dtype}: max_abs_err {err:.3e} (tol {tol:g})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"paged_attention {dtype} disagrees with its plain version")
    live = int(ctx.sum())
    nbytes = (q.numel() * 2 + 2 * live * kh * hd * 2 + tables.numel() * 4
              + lens.numel() * 4 + b * h * hd * 4)
    flops = 4 * live * h * hd                      # q.k and p.v, f32
    bnd, by = bound_ms(nbytes, flops, peaks)
    rows["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:91",
        max_abs_err=max(errs.values()),
        ms=time_ms(lambda: kernels_pa.paged_attention(q, kb, vb, tables, lens)),
        plain_ms=time_ms(lambda: ref.paged_attention(q, kb, vb, tables, lens)),
        bound_ms=bnd, bound_by=by, library_ms=None)

    # paged_decode_write: one bf16 token per lane into the pool, 2 pad
    # lanes aimed at the null block
    pool_k = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    pool_v = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    nk = torch.randn(b, kh, hd, generator=gen).bfloat16().to(dev)
    nv = torch.randn(b, kh, hd, generator=gen).bfloat16().to(dev)
    ids = torch.cat([torch.randperm(p - 1, generator=gen)[: b - 2],
                     torch.tensor([p - 1, p - 1])]).int().to(dev)
    offs = torch.randint(0, bs, (b,), generator=gen).int().to(dev)
    k1, v1 = kernels_pa.paged_decode_write(pool_k.clone(), pool_v.clone(), nk, nv, ids, offs)
    k2, v2 = ref.paged_decode_write(pool_k.clone(), pool_v.clone(), nk, nv, ids, offs)
    torch.cuda.synchronize()
    err = max((k1[:-1].float() - k2[:-1].float()).abs().max().item(),
              (v1[:-1].float() - v2[:-1].float()).abs().max().item())
    log(f"  paged_decode_write bf16: max_abs_err {err:.3e} (exact; null block excluded)")
    if err != 0.0:
        fail("paged_decode_write disagrees with its plain version")
    nbytes = 2 * (2 * b * kh * hd * 2) + 2 * b * 4
    bnd, by = bound_ms(nbytes, 0, peaks)
    rows["paged_decode_write"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:160", max_abs_err=err,
        ms=time_ms(lambda: kernels_pa.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)),
        plain_ms=time_ms(lambda: ref.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)),
        bound_ms=bnd, bound_by=by, library_ms=None)

    # masked_dequant: the MLP weight slices of one unit, bf16 out, the
    # free tier's interval plus an inert slot
    lo, hi = ops.pack_intervals([(0.0, 0.01), (0.3, 0.3)], dev)
    worst, times = 0.0, []
    for r_, c_ in ((2048, 11008), (11008, 2048)):
        codes = torch.randint(-127, 128, (r_, c_), generator=gen,
                              dtype=torch.int8).to(dev)
        scale = (torch.rand(1, c_, generator=gen) * 4e-4 + 1e-5).to(dev)
        got = kernels_md.masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)
        want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        exact = torch.equal(got, want)
        log(f"  masked_dequant {r_}x{c_} bf16: max_abs_err {err:.3e} (exact), "
            f"masked {float((got == 0).float().mean()):.3f}")
        if not exact:
            fail(f"masked_dequant {r_}x{c_} disagrees with its plain version")
        worst = max(worst, err)
        times.append((
            time_ms(lambda: kernels_md.masked_dequant(codes, scale, lo, hi,
                                                      out_dtype=torch.bfloat16)),
            time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16),
                    iters=10)))
    n = 2048 * 11008                               # per slice, both shapes
    nbytes = n * 1 + 11008 * 4 + 2 * 8 * 4 + n * 2
    flops = n * (2 + 3 * ops.MAX_INTERVALS)        # mul, abs, 8 x (2 compares, or)
    bnd, by = bound_ms(nbytes, flops, peaks)
    rows["masked_dequant"] = dict(
        route="triton", source="src/repro_torch/kernels/masked_dequant.py",
        replaces="src/repro/kernels/masked_dequant.py:39", max_abs_err=worst,
        ms=times[0][0], plain_ms=times[0][1], bound_ms=bnd, bound_by=by,
        library_ms=None)
    log(f"  masked_dequant 11008x2048: {times[1][0]:.4f} ms (plain {times[1][1]:.4f} ms)")
    for name, row in rows.items():
        log(f"  {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# ------------------------------------------------------------ phase 3 / 4
PROMPT_LENS = [23, 64, 37, 50, 9, 61, 17, 44, 30, 58, 12, 40]
GEOMETRY = dict(max_batch=8, max_prompt=64, max_new_cap=32)


def submit_all(gw, cfg, np):
    rng = np.random.default_rng(SEED)
    reqs = []
    for i, n in enumerate(PROMPT_LENS):
        prompt = rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
        reqs.append(gw.submit(prompt, license="free" if i % 2 else "full",
                              max_new_tokens=16 + (i % 3) * 8))
    return reqs


def serve(label, gw, cfg, np, torch):
    """Drain one request stream; returns its requests and timings."""
    t0 = time.perf_counter()
    for tier in ("full", "free"):                  # build the views first
        gw.view_for(tier)
    sync()
    t_views = time.perf_counter() - t0
    reqs = submit_all(gw, cfg, np)
    t0 = time.perf_counter()
    gw.run()
    sync()
    t_run = time.perf_counter() - t0
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    if not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"{label}: token ids outside the vocabulary")
    m = gw.metrics()
    log(f"  {label}: {len(reqs)} requests, {m['tokens_generated']} tokens, "
        f"{m['decode_steps']} decode steps, {m['prefill_chunks']} prefill chunks; "
        f"views {t_views:.2f} s, serving {t_run:.2f} s "
        f"({m['tokens_generated'] / t_run:.1f} tokens/s, "
        f"{1e3 * t_run / max(1, m['decode_steps'] + m['prefill_chunks']):.1f} ms/step)")
    return reqs, dict(views_s=t_views, serve_s=t_run,
                      tokens=m["tokens_generated"], decode_steps=m["decode_steps"],
                      prefill_chunks=m["prefill_chunks"])


def decode_logits_check(gw, cfg, np, torch):
    """Bring a stream to mid-decode, then run one decode step through the
    kernels and through the plain path on two copies of the same pool."""
    from repro_torch.serving.engine import serve_step_paged

    submit_all(gw, cfg, np)
    group = []
    while len(group) < 4:
        if gw.step() is None:
            fail("stream drained before reaching mid-decode")
        group = [r for r in gw.scheduler.running
                 if r.state.value == "running" and len(r.out_tokens) >= 3]
    tier = group[0].license
    reqs = gw._grow_block_tables([r for r in group if r.license == tier])
    bsz, bs, dev = gw.max_batch, gw.pool.block_size, gw.device
    lanes = gw.pool.pad_lanes([r.lane for r in reqs], bsz)
    toks = np.zeros((bsz, 1), np.int32)
    poss = np.zeros(bsz, np.int32)
    for i, r in enumerate(reqs):
        toks[i, 0], poss[i] = r.out_tokens[-1], r.pos
    used = max(r.pos // bs + 1 for r in reqs)
    tables = gw.pool.pad_tables([r.blocks[:used] for r in reqs], bsz, used)
    view = gw.view_for(tier)
    out = []
    for kernel in (True, False):
        cache = gw.pool.decode_cache(lanes)
        cache["units"]["b0"]["k"] = gw.pool.k.clone()
        cache["units"]["b0"]["v"] = gw.pool.v.clone()
        logits, _ = serve_step_paged(
            view, cfg, torch.from_numpy(toks).to(dev), cache,
            torch.from_numpy(tables).to(dev), torch.from_numpy(poss).to(dev),
            kernel=kernel)
        out.append(logits[: len(reqs), : cfg.vocab_size].float())
    err = (out[0] - out[1]).abs().max().item()
    scale = out[1].abs().max().item()
    same = int((out[0].argmax(-1) == out[1].argmax(-1)).sum())
    if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
        fail("decode logits are not finite")
    return err, scale, same, len(reqs), tier


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.kernels import masked_dequant as kernels_md
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as kernels_pa
    from repro_torch.kernels.build import load_extension
    from repro_torch.models import init_params
    from repro_torch.serving import LicensedGateway

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in CARD_PEAKS.items() if k in kind), None)
    if peaks is None:
        fail(f"no published peaks for {kind!r}; bounds cannot be derived")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    t0 = time.perf_counter()
    load_extension()
    log(f"phase 1: CUDA kernels built in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- phase 2
    log("phase 2: kernels vs their plain versions")
    rows = check_kernels(peaks, torch, ops, ref, kernels_pa, kernels_md)

    # ---------------------------------------------------------- phase 3
    log(f"phase 3: LicensedGateway, {ARCH} at full width and depth")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {n_params / 1e9:.3f} B parameters ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.padded_vocab}, {cfg.dtype_name}) in {time.perf_counter() - t0:.1f} s")
    tiers = {"free": LicenseTier(name="free", masks=FREE_TIER)}
    ops.reset_launches()
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    float_reqs, float_t = serve("float views", gw, cfg, np, torch)
    del gw                      # slot <-> gateway cycle: collect its views
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, quantized=True,
                         materialize_int8_views=True, **GEOMETRY)
    _, int8_t = serve("int8 views", gw, cfg, np, torch)
    launches = dict(ops.LAUNCHES)
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---------------------------------------------------------- phase 4
    log("phase 4: kernel path vs plain path")
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    err, scale, same, n_lanes, tier = decode_logits_check(gw, cfg, np, torch)
    # bf16 tolerance: the kernel returns f32 attention cast once to bf16,
    # the plain path casts probabilities to bf16 before the value product;
    # 36 layers of bf16 residual rounding separate the two
    tol = 0.05 * max(scale, 1.0)
    log(f"  one decode step ({n_lanes} lanes, tier {tier}): max |logit diff| "
        f"{err:.4f} vs max |logit| {scale:.3f} (tol {tol:.4f}); "
        f"argmax agrees on {same}/{n_lanes} lanes")
    if not err <= tol:
        fail("decode logits of the kernel path and the plain path disagree")
    del gw
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, decode_kernels=False, **GEOMETRY)
    plain_reqs, plain_t = serve("float views, plain decode path", gw, cfg, np, torch)
    agree = sum(a == b for r1, r2 in zip(float_reqs, plain_reqs)
                for a, b in zip(r1.out_tokens, r2.out_tokens))
    total = sum(len(r.out_tokens) for r in float_reqs)
    log(f"  greedy tokens equal between kernel and plain decode: {agree}/{total} "
        f"(information only: bf16 rounding may flip near-ties)")

    # ---------------------------------------------------------- phase 5
    kernels = [dict(name=name, launches=launches[name], **row)
               for name, row in rows.items()]
    log(json.dumps({"gateway": {"float": float_t, "int8": int8_t,
                                "plain_decode": plain_t,
                                "decode_logits_max_abs_err": err}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
