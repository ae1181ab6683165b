"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in this checkout (``src/repro_torch/kernels``);
2. every kernel of the main paths against its plain PyTorch version, on
   the card, at the shapes the gateway gives it, with its time (CUDA
   events), the plain version's time, the time of one PyTorch library
   call computing the same function where there is one, and its bound
   on this card (``paged_attention`` at three decode shapes: contexts
   1-600, the serving stream's 9-96 and 8 x 4096 tokens, each back to
   back, in a CUDA graph and, the last, L2-cold; ``paged_decode_write``
   back to back and in a graph; the last three back to back also as the
   extension call alone, without the wrapper's Python); ``masked_dequant``
   bit for bit on two weight slices of a unit (back to back, in a graph,
   L2-cold) and on a whole stacked (36, 2048, 11008) leaf, as one launch
   and as the per-slice loop with a stack; ``delta_apply_inplace`` also in
   a graph beside ``index_put_``; then the prefill
   attention and int8 MLP product
   (``flash_attention`` and ``ops.quant_matmul``, which no serving path
   calls) driven through their entry points at qwen2.5-3b's shapes, with
   the launch counters zeroed just before and read just after, and the
   same checks and times;
3. the serving path: ``LicensedGateway`` serving requests in two license
   tiers at the full width and depth of qwen2.5-3b (random bf16 weights
   from a seed), through float views and through int8 views built by the
   fused masked-dequant; the launch counters are zeroed just before and
   read just after, and every kernel must have run; each view build is
   timed (host clock and CUDA events, masked_dequant launches, peak
   memory); then the whole int8 view of the free and full tiers rebuilt
   from the store and held bit for bit against the plain version, and
   ``quant_matmul`` on a real leaf of the int8 store (unit 0's
   ``ffn/w_up``) against x @ its masked-dequant.  Every gateway of the
   script is the default one (prefix cache and telemetry on) unless a
   phase says otherwise.  The float stream runs three times: with
   ``telemetry=False``, with telemetry (the run phase 4 reads), and
   without again; the greedy tokens must be identical, and tokens/s, ms
   per step and telemetry's overhead are printed (not gated).  The
   telemetry run's Chrome trace must pass ``validate_chrome_trace`` and
   its ``metrics()`` ``validate_gateway_metrics``; the six latency
   histograms (p50 / p99 / count) and counters read back from the
   Prometheus page are printed.  Then 8 decode steps of the same stream
   run under ``torch.profiler`` (CPU and CUDA): the device-busy share of
   the window (the union of kernel, copy and set intervals), kernel
   launches per step and the five kernels with the most device time;
3b. the shared-prefix stream (a 48-token system prefix, own suffixes of
   1-16 tokens, exact repeats; two waves) at full width and depth, launch
   counters zeroed just before and read just after: (a) with the prefix
   cache, (b) without it, (c) with it on a 12-block pool, (d) with it
   through int8 views.  (a) must reuse prefix tokens, copy shared tails
   and prefill fewer lane-tokens than (b); (c) must evict retained chains
   and preempt; every request must finish; no decode write may target a
   shared block; after each drain the allocator holds only the tree's
   references; and the greedy tokens of (a) and (c) must equal (b)'s or
   part at a near-tie by phase 4's rule.  (a) and (c) run sanitized
   (``sanitize=True``: shadow refcounts on every allocator call,
   ``check_decode_writes`` before each decode write, ``check_drained`` at
   each drain), and the shadow must equal the allocator's refcounts;
4. one decode step's logits through the kernels vs the plain path on the
   same pool state; every lane whose argmax differs must be a near-tie
   (the plain path's gap between the two tokens below the step's max
   |logit diff|); then the greedy-token agreement of a whole plain-path
   run with phase 3's float stream, and for each request the first step
   at which its tokens part, read from both streams' own logits rows at
   that step: the plain path's gap between the two tokens must lie below
   the lane's max |logit diff|, and that diff within the decode step's
   tolerance;
5. the update path (paper §3.1.2, §4.3), launch counters zeroed just
   before: a ``LicenseServer`` over an in-memory ``WeightStore`` gets v1
   (phase 3's weights) and a ``free`` tier; a float gateway boots
   ``from_server`` at full width and depth (the boot pull through the
   ``delta_apply`` kernel, checked bit for bit against v1) and takes
   phase 3's request stream; v2 (units 32-35 changed: norms and q/k/v
   biases as rows, 1% of each block matrix as chunk pages) is published
   and staged mid-stream (``begin_sync`` then ``run``).  The in-flight
   requests must stay on v1 with phase 3's tokens, exactly one flip must
   happen, the flipped weights must equal v2 bit for bit, and a request
   after the flip must be served on v2 through a prewarmed view.  The
   audit must hold one ``sync_begin`` and one ``version_flip``, the trace
   one ``stager:<phase>`` span per stager step; their ``h_stager`` p50 /
   p99 / max (host clock, no synchronize) print beside the script's
   synchronized longest step.  The third step carrying a stage step runs
   under ``torch.profiler`` as in phase 3;
6. the same sync on an int8 gateway with materialized views, at full
   width and a depth of 4 units (a second full-depth boot pull would
   cost the same host time again); its v2 int8 store must equal
   ``quantize_serving_params(v2)``.  Both ``delta_apply`` forms must have
   been launched on phases 5-6;
7. Algorithm 1 on phase 3's weights (re-created from the seed and
   checked): the quantile edges of every maskable magnitude (by a count
   of bf16 bit patterns on the card, checked against a sort on one
   leaf), ``calibrate_license`` to a top-1 agreement of 0.9 over 16
   teacher-forced 64-token prompts, the tier re-evaluated, its float view
   in a gateway held bit for bit against ``apply_license``, and the
   shared-prefix stream served in it with the prefix cache;
8. a ``kernels`` JSON line, and the result line last.

Imports nothing of JAX.  Exits non-zero without a result when no CUDA
device is present or when run outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "qwen2.5-3b"
FREE_TIER = {"*": ((0.0, 0.01),)}

# published peaks (NVIDIA data sheets, SXM parts): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (the rate the kernels' f32 arithmetic runs at),
# and the dense bf16 tensor-core FLOP/s (bounds work on bf16 inputs)
CARD_PEAKS = {"H100": (3.35e12, 67e12, 989e12), "H200": (4.8e12, 67e12, 989e12)}
RATE_NAMES = {1: "f32 67e12 FLOP/s", 2: "bf16 tensor cores 989e12 FLOP/s"}


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


def time_graph_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 4) -> float:
    """Device time of ``fn`` in ms without the host's cost of launching it:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events (a decode step would run captured, too)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def host_split_ms(wrapped, bare, reps: int = 5):
    """Back-to-back ms of a wrapper and of its extension call alone (pybind,
    device guard, launch; none of the wrapper's Python), ``reps`` rounds
    of ``time_ms`` alternating which goes first; the two medians."""
    import statistics

    got = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            got[i].append(time_ms((wrapped, bare)[i]))
    return statistics.median(got[0]), statistics.median(got[1])


def rotating(fns):
    """One callable that runs ``fns`` in turn, one per call: timed, each
    call reads another copy of its operands, so copies whose sum exceeds
    the card's L2 are read from device memory."""
    turn = [0]

    def call():
        fns[turn[0] % len(fns)]()
        turn[0] += 1
    return call


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bound_ms(nbytes: float, flops: float, peaks, rate: int = 1) -> tuple:
    """Least time for the work on this card: the larger of bytes over the
    memory rate and operations over the f32 rate (``rate=2``: the bf16
    tensor-core rate)."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# paged_attention at qwen2.5-3b's decode shape (16 q heads over 2 kv heads,
# head_dim 128) on 16-token blocks, bf16 in the cases below, held to 1e-5 of
# the plain version (both compute in f32 from the same values; only the
# order of the sums differs).  Beyond phase 2's ragged case (contexts
# 1-600): the serving stream's own contexts (prompts 9-64 plus up to 32 new
# tokens) and a decode after a 4096-token prefill on each of 8 lanes, also
# timed L2-cold over PA_COLD_COPIES copies of its 33.6 MB of K/V
PA_SHAPE = (16, 2, 128, 16)           # q heads, kv heads, head_dim, block size
PA_TOL = 1e-5
PA_CASES = {"serving": [9, 23, 40, 57, 64, 75, 88, 96], "long": [4096] * 8}
PA_COLD_COPIES = 4


def paged_bound(peaks, q, lens):
    """Bound of one ``paged_attention`` call: q, every live K/V row of its
    kv heads, the table, the lengths and the f32 output once; q.k and p.v in
    f32 over the live keys."""
    h, kh, hd, _ = PA_SHAPE
    b, elt, live = q.shape[0], q.element_size(), int(lens.sum())
    t_cols = -(-int(lens.max()) // PA_SHAPE[3])
    nbytes = (q.numel() * elt + 2 * live * kh * hd * elt + b * t_cols * 4 + b * 4
              + q.numel() * 4)
    return bound_ms(nbytes, 4 * live * h * hd, peaks)


def paged_plan(kernels_pa, t_cols, b, torch):
    """The (splits, columns per split) the wrapper launches at this shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(kernels_pa.split_plan(t_cols, PA_SHAPE[3], b, PA_SHAPE[1], sms))


def paged_case(torch, kernels_pa, ref, peaks, gen, lens, cold=False):
    """One bf16 decode step at contexts ``lens``: error against the plain
    version, times back to back (the wrapper and the extension call alone),
    in a CUDA graph and (``cold``) L2-cold in a graph, bound and split plan.
    Dead table entries name the null block."""
    from repro_torch.kernels.build import load_extension

    dev = torch.device("cuda")
    h, kh, hd, bs = PA_SHAPE
    b, t_cols = len(lens), -(-max(lens) // bs)
    p = b * t_cols + 1
    tables = torch.randperm(p - 1, generator=gen)[: b * t_cols].reshape(b, t_cols)
    for i, n in enumerate(lens):
        tables[i, -(-n // bs):] = p - 1
    tables = tables.int().to(dev)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, hd, generator=gen).bfloat16().to(dev)
    kb = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)
    vb = torch.randn(p, bs, kh, hd, generator=gen).bfloat16().to(dev)

    def attend(k=kb, v=vb):
        return kernels_pa.paged_attention(q, k, v, tables, ctx)

    got = attend()
    want = ref.paged_attention(q, kb, vb, tables, ctx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err > PA_TOL:
        fail(f"paged_attention at contexts {min(lens)}-{max(lens)} disagrees with its "
             f"plain version (max_abs_err {err:.3e})")
    del got, want
    bnd, by = paged_bound(peaks, q, ctx)
    splits, cols = paged_plan(kernels_pa, t_cols, b, torch)
    ws = torch.empty((splits, b, h, hd + 2) if splits > 1 else (0,), device=dev)
    ext = load_extension()
    ms, ms_ext = host_split_ms(attend, lambda: ext.paged_attention(q, kb, vb, tables, ctx,
                                                                   ws, cols))
    row = dict(lens=f"{min(lens)}-{max(lens)}", table_cols=t_cols, live_tokens=sum(lens),
               max_abs_err=err, ms=ms, ms_ext=ms_ext, ms_graph=time_graph_ms(attend),
               plain_ms=time_ms(lambda: ref.paged_attention(q, kb, vb, tables, ctx),
                                iters=10, warmup=2),
               bound_ms=bnd, bound_by=by, split_plan=[splits, cols])
    if cold:
        pools = [(kb, vb)] + [(kb.clone(), vb.clone()) for _ in range(PA_COLD_COPIES - 1)]
        row["ms_cold"] = time_graph_ms(rotating([lambda k=k, v=v: attend(k, v)
                                                 for k, v in pools]))
        row["cold_copies"] = PA_COLD_COPIES
        del pools
        torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 2
def check_kernels(peaks, torch, ops, ref, kernels_pa, kernels_md):
    """Each kernel vs its plain version at the main path's shapes."""
    from repro_torch.kernels.build import load_extension

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rows = {}

    # paged_attention: a decode step of 8 lanes, 16 heads over 2 kv heads,
    # head_dim 128, 16-token blocks, ragged contexts up to ~600 tokens
    h, kh, hd, bs = PA_SHAPE
    b = 8
    ctx = torch.tensor([1, 17, 100, 255, 311, 480, 555, 600], dtype=torch.int32)
    t_cols = int((ctx.max() + bs - 1) // bs)
    p = b * t_cols + 1
    tables = torch.randperm(p - 1, generator=gen)[: b * t_cols].reshape(b, t_cols)
    for i, n in enumerate(ctx.tolist()):           # dead entries -> null block
        tables[i, -(-n // bs):] = p - 1
    tables, lens = tables.int().to(dev), ctx.to(dev)
    errs = {}
    for dtype, tol in ((torch.float32, PA_TOL), (torch.bfloat16, PA_TOL)):
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
    bnd, by = paged_bound(peaks, q, lens)

    def attend():
        return kernels_pa.paged_attention(q, kb, vb, tables, lens)

    cases = {"phase2": dict(
        lens="1-600", table_cols=t_cols, live_tokens=int(ctx.sum()),
        max_abs_err=max(errs.values()), ms=time_ms(attend), ms_graph=time_graph_ms(attend),
        plain_ms=time_ms(lambda: ref.paged_attention(q, kb, vb, tables, lens)),
        bound_ms=bnd, bound_by=by, split_plan=paged_plan(kernels_pa, t_cols, b, torch))}
    pa_gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    for name, case_lens in PA_CASES.items():
        cases[name] = paged_case(torch, kernels_pa, ref, peaks, pa_gen, case_lens,
                                 cold=name == "long")
    for name, c in cases.items():
        cold = f", L2-cold {c['ms_cold']:.4f} ms" if "ms_cold" in c else ""
        alone = f" (extension call alone {c['ms_ext']:.4f})" if "ms_ext" in c else ""
        log(f"  paged_attention {name} bf16 [ctx {c['lens']}, {c['table_cols']} table "
            f"columns, split plan {c['split_plan']}]: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {PA_TOL:g}), {c['ms']:.4f} ms back to back{alone}, {c['ms_graph']:.4f} ms in "
            f"a CUDA graph{cold}, plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
            f"ms ({c['bound_by']})")
    head = cases["phase2"]
    rows["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:91",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=head["ms"], ms_graph=head["ms_graph"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
        headline="phase2 bf16", cases=cases)

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

    def write():
        return kernels_pa.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)

    ext = load_extension()
    ms, ms_ext = host_split_ms(write, lambda: ext.paged_decode_write(pool_k, pool_v, nk, nv,
                                                                     ids, offs))
    rows["paged_decode_write"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:160", max_abs_err=err,
        ms=ms, ms_ext=ms_ext, ms_graph=time_graph_ms(write),
        plain_ms=time_ms(lambda: ref.paged_decode_write(pool_k, pool_v, nk, nv, ids, offs)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    row = rows["paged_decode_write"]
    log(f"  paged_decode_write: {row['ms']:.4f} ms back to back (median of 5; the extension "
        f"call alone {row['ms_ext']:.4f} ms), {row['ms_graph']:.4f} ms in a CUDA graph")

    rows["masked_dequant"] = check_masked_dequant(peaks, torch, ops, ref, kernels_md, gen)
    rows.update(check_delta_apply(peaks, torch, ref, dev, gen))
    for name, row in rows.items():
        log(f"  {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# masked_dequant at the shapes of a licensed view of qwen2.5-3b: the MLP
# weight slices of one unit both ways and the whole stacked ffn/w_up leaf,
# bf16 out, the free tier's interval plus an inert slot; every output held
# bit for bit against the plain version
MD_INTERVALS = [(0.0, 0.01), (0.3, 0.3)]
MD_SLICES = [(2048, 11008), (11008, 2048)]
MD_LEAF = (36, 2048, 11008)
MD_SOURCE = "src/repro_torch/kernels/csrc/masked_dequant.cu"


def md_bound(peaks, n, cols_scale, live, out_bytes=2):
    """Bytes: the codes, the scale and the 16 interval floats read once and
    the output written once; operations: a multiply, an abs and, per live
    interval, two compares and a select per element (f32 rate)."""
    return bound_ms(n + cols_scale * 4 + 16 * 4 + n * out_bytes, n * (2 + 3 * live), peaks)


def md_exact(got, want):
    """Same dtype and the same bit patterns (+0.0 and -0.0 differ)."""
    import torch

    bits = torch.int16 if got.element_size() == 2 else torch.int32
    return got.dtype == want.dtype and bool(torch.equal(got.view(bits), want.view(bits)))


def check_masked_dequant(peaks, torch, ops, ref, kernels_md, gen):
    """The slices and the leaf above: bit-exact against the plain version,
    times back to back, in a CUDA graph and (slices) L2-cold in a graph
    over COLD_COPIES copies of the codes; the leaf both as one launch and
    as the per-slice loop with a stack (a view build one 2-D slice per
    launch)."""
    dev = torch.device("cuda")
    lo, hi = ops.pack_intervals(MD_INTERVALS, dev)
    live = sum(1 for a, b in MD_INTERVALS if a < b)
    cases = {}

    def call(codes, scale):
        return kernels_md.masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)

    for r_, c_ in MD_SLICES:
        codes = torch.randint(-127, 128, (r_, c_), generator=gen, dtype=torch.int8).to(dev)
        scale = (torch.rand(1, c_, generator=gen) * 4e-4 + 1e-5).to(dev)
        got = call(codes, scale)
        want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not md_exact(got, want):
            fail(f"masked_dequant {r_}x{c_} disagrees with its plain version "
                 f"(max_abs_err {err:.3e})")
        masked = float((got == 0).float().mean())
        del got, want
        copies = [codes] + [codes.clone() for _ in range(COLD_COPIES - 1)]
        bnd, by = md_bound(peaks, r_ * c_, c_, live)
        cases[f"slice {r_}x{c_}"] = dict(
            max_abs_err=err, masked=masked, ms=time_ms(lambda: call(codes, scale)),
            ms_graph=time_graph_ms(lambda: call(codes, scale)),
            ms_cold=time_graph_ms(rotating([lambda c=c: call(c, scale) for c in copies])),
            plain_ms=time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16),
                             iters=10),
            bound_ms=bnd, bound_by=by)
        del copies, codes
        torch.cuda.empty_cache()

    u, r_, c_ = MD_LEAF
    codes = torch.randint(-127, 128, MD_LEAF, generator=gen, dtype=torch.int8).to(dev)
    scale = (torch.rand(u, 1, c_, generator=gen) * 4e-4 + 1e-5).to(dev)

    def per_slice():
        return torch.stack([call(codes[i], scale[i]) for i in range(u)])

    want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
    forms = {"per_slice_stack": per_slice, "one_launch": lambda: call(codes, scale)}
    bnd, by = md_bound(peaks, codes.numel(), u * c_, live)
    leaf = dict(shape=f"{MD_LEAF} int8, scale ({u}, 1, {c_}), bf16 out", bound_ms=bnd,
                bound_by=by, max_abs_err=0.0)
    for name, fn in forms.items():
        got = fn()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not md_exact(got, want):
            fail(f"masked_dequant on the {MD_LEAF} leaf ({name}) disagrees with its plain "
                 f"version (max_abs_err {err:.3e})")
        del got
        leaf["max_abs_err"] = max(leaf["max_abs_err"], err)
        leaf[f"{name}_ms"] = time_ms(fn, iters=10, warmup=2)
        leaf[f"{name}_ms_graph"] = time_graph_ms(fn, iters=5, reps=3, warmup=1)
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    leaf["plain_ms"] = time_ms(lambda: ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16),
                               iters=2, warmup=1)
    # a yardstick of the card's streaming rate, not the function: a copy
    # of a bf16 tensor of the leaf's shape (its bytes read and written once)
    dst = torch.empty(MD_LEAF, dtype=torch.bfloat16, device=dev)
    src = torch.zeros_like(dst)
    leaf["copy_ms"] = time_ms(lambda: dst.copy_(src), iters=10, warmup=2)
    leaf["copy_tb_s"] = 2 * dst.numel() * 2 / leaf["copy_ms"] / 1e9
    leaf["one_launch_tb_s"] = codes.numel() * 3 / leaf["one_launch_ms"] / 1e9
    del dst, src
    cases["leaf ffn/w_up"] = leaf
    del codes, scale
    torch.cuda.empty_cache()

    for name, c in cases.items():
        if name.startswith("slice"):
            log(f"  masked_dequant {name} bf16: bit-exact, masked "
                f"{c['masked']:.3f}, {c['ms']:.4f} ms back to back, {c['ms_graph']:.4f} ms in "
                f"a CUDA graph, L2-cold {c['ms_cold']:.4f} ms ({COLD_COPIES} copies), plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        else:
            log(f"  masked_dequant {name} [{c['shape']}]: bit-exact; per-slice "
                f"launches + stack {c['per_slice_stack_ms']:.4f} ms back to back, "
                f"{c['per_slice_stack_ms_graph']:.4f} ms in a graph; one launch "
                f"{c['one_launch_ms']:.4f} ms back to back ({c['one_launch_tb_s']:.2f} TB/s), "
                f"{c['one_launch_ms_graph']:.4f} ms in a graph; plain "
                f"{c['plain_ms']:.4f} ms, a bf16 copy of the leaf's shape {c['copy_ms']:.4f} "
                f"ms ({c['copy_tb_s']:.2f} TB/s), bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    head = cases[f"slice {MD_SLICES[0][0]}x{MD_SLICES[0][1]}"]
    return dict(route="cuda", source=MD_SOURCE,
                replaces="src/repro/kernels/masked_dequant.py:39",
                max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                ms=head["ms"], ms_graph=head["ms_graph"], ms_cold=head["ms_cold"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, headline=f"slice {MD_SLICES[0][0]}x{MD_SLICES[0][1]} bf16",
                cases=cases)


def view_build(torch, ops, build):
    """One licensed view build: its result, and its time on the stream
    (CUDA events around it), on the host clock (ending in a synchronize),
    its masked_dequant launches and the peak device memory during it (and
    above what was allocated before it)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = ops.LAUNCHES["masked_dequant"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    view = build()
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return view, dict(device_ms=start.elapsed_time(end), host_s=host_s,
                      launches=ops.LAUNCHES["masked_dequant"] - n0, peak_gb=peak / 1e9,
                      peak_above_gb=(peak - before) / 1e9)


def view_bound(peaks, store, live):
    """Bound of one int8 view build: md_bound summed over the store's
    quantized leaves (bf16 out)."""
    n = scales = 0
    for _, leaf in _qpaths(store):
        n += leaf["codes"].numel()
        scales += leaf["scale"].numel()
    return md_bound(peaks, n, scales, live)


def view_cases(peaks, torch, ops, store, free, dtype, reps=3):
    """The whole int8 view of the free tier and of the full one, built
    from ``store`` by ``materialize_licensed_view`` ``reps`` times each (the
    gateway's path without its cache), bit-exact against the plain
    version leaf by leaf; the median build and the largest peak."""
    import statistics

    from repro_torch.kernels import ref
    from repro_torch.serving.quantized import materialize_licensed_view, tier_intervals

    cases = {}
    for tier in (free, None):
        name = f"view {tier.name if tier else 'full'}"
        li = tier_intervals(tier)
        live = 0 if li is None else int((li[1] > li[0]).sum())
        runs = []
        for _ in range(reps):
            view, got = view_build(torch, ops, lambda: materialize_licensed_view(
                store, tier, dtype))
            runs.append(got)
            if len(runs) < reps:
                del view
        dev = next(_qpaths(store))[1]["codes"].device
        lo, hi = (t.to(dev) for t in (li if li is not None else ops.pack_intervals([])))
        for path, q in _qpaths(store):
            want = ref.masked_dequant(q["codes"], q["scale"], lo, hi, dtype)
            if not md_exact(_at(view, path), want):
                fail(f"masked_dequant: {name} differs from the plain version at {path}")
            del want
        del view
        torch.cuda.empty_cache()
        bnd, by = view_bound(peaks, store, live)
        cases[name] = dict(
            device_ms=statistics.median(r["device_ms"] for r in runs),
            host_s=statistics.median(r["host_s"] for r in runs),
            launches=runs[0]["launches"], peak_gb=max(r["peak_gb"] for r in runs),
            peak_above_gb=max(r["peak_above_gb"] for r in runs), reps=reps,
            bound_ms=bnd, bound_by=by)
        c = cases[name]
        log(f"  masked_dequant {name} (bf16, bit-exact): {c['launches']} "
            f"launches, {c['device_ms']:.3f} ms on the stream, {c['host_s']:.4f} s host "
            f"(medians of {reps}), peak {c['peak_gb']:.2f} GB ({c['peak_above_gb']:.2f} GB "
            f"above the store), bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return cases


def _qpaths(tree, path=()):
    if isinstance(tree, dict) and "codes" in tree and "scale" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qpaths(v, path + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_delta_apply(peaks, torch, ref, dev, gen):
    """Both forms of the scatter kernel vs the plain version, bit-exact:
    out of place at the boot pull's largest layer (every index of a
    36x2048x11008 bf16 buffer, bf16 values), in place at a staged-sync
    part (a 36x2048 bf16 norm, f32 values for units 32-35, plus padding
    indices equal to N).  The library column is one ``index_put`` call
    (in-range indices, values already in buf's dtype)."""
    from repro_torch.kernels.delta_apply import delta_apply

    forms = {}
    # out of place, boot shape: every index of the buffer (n = N)
    n = 36 * 2048 * 11008
    buf = torch.zeros(n, dtype=torch.bfloat16, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    val = torch.randn(n, dtype=torch.float32, device=dev).bfloat16()
    got = delta_apply(buf, idx, val)
    want = ref.delta_apply(buf, idx, val)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want) or buf.count_nonzero().item():
        fail("delta_apply (out of place) disagrees with its plain version")
    del got, want
    # the function's bytes, not the clone-then-scatter design's: n int64
    # indices and bf16 values read, buf read once and the output written
    # once (N x 2 B each)
    bnd, by = bound_ms(n * (8 + 2) + 2 * n * 2, 0, peaks)
    forms["delta_apply"] = dict(
        shape=f"N={n} bf16, n={n} int64 / bf16", max_abs_err=err,
        replaces="src/repro/kernels/delta_apply.py:63",
        ms=time_ms(lambda: delta_apply(buf, idx, val), iters=20, warmup=2),
        plain_ms=time_ms(lambda: ref.delta_apply(buf, idx, val), iters=3, warmup=1),
        library_ms=time_ms(lambda: buf.index_put((idx,), val), iters=20, warmup=2),
        bound_ms=bnd, bound_by=by)
    del buf, idx, val
    torch.cuda.empty_cache()

    # in place, a sync part: 8,192 f32 values into a bf16 norm + padding
    n_buf, pad = 36 * 2048, 16
    buf = torch.randn(n_buf, generator=gen).bfloat16().to(dev)
    live = torch.arange(32 * 2048, 36 * 2048, dtype=torch.int64)
    idx = torch.cat([live[torch.randperm(live.numel(), generator=gen)],
                     torch.full((pad,), n_buf, dtype=torch.int64)]).to(dev)
    val = torch.randn(idx.numel(), generator=gen).to(dev)
    work = buf.clone()
    got = delta_apply(work, idx, val, donate=True)
    want = ref.delta_apply(buf.clone(), idx, val, donate=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if got.data_ptr() != work.data_ptr() or not torch.equal(got, want):
        fail("delta_apply_inplace disagrees with its plain version")
    n_live = live.numel()
    # every int64 index and f32 value read; only the in-range entries write
    bnd, by = bound_ms(idx.numel() * (8 + 4) + n_live * 2, 0, peaks)
    in_range, cast = idx[:n_live], val[:n_live].bfloat16()
    forms["delta_apply_inplace"] = dict(
        shape=f"N={n_buf} bf16, n={idx.numel()} int64 / f32 ({pad} padding)",
        max_abs_err=err, replaces="src/repro/kernels/delta_apply.py:82",
        ms=time_ms(lambda: delta_apply(work, idx, val, donate=True)),
        ms_graph=time_graph_ms(lambda: delta_apply(work, idx, val, donate=True)),
        plain_ms=time_ms(lambda: ref.delta_apply(work, idx, val, donate=True)),
        library_ms=time_ms(lambda: work.index_put_((in_range,), cast)),
        library_ms_graph=time_graph_ms(lambda: work.index_put_((in_range,), cast)),
        bound_ms=bnd, bound_by=by)
    for name, f in forms.items():
        graph = (f"; in a CUDA graph {f['ms_graph']:.4f} ms, index_put_ "
                 f"{f['library_ms_graph']:.4f} ms" if "ms_graph" in f else "")
        log(f"  {name} [{f['shape']}]: max_abs_err {f['max_abs_err']:.1e} (exact), "
            f"{f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, index_put "
            f"{f['library_ms']:.4f} ms back to back{graph}, bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']})")
    return {name: dict(route="cuda", source="src/repro_torch/kernels/csrc/delta_apply.cu",
                       **f) for name, f in forms.items()}


# the prefill attention and MLP shapes of qwen2.5-3b (16 q heads over 2 kv
# heads, head_dim 128, d_model 2048, d_ff 11008): one layer of a 4096-token
# prompt's causal prefill, the same under a 1024-token window, and the
# prompt's last 256-token chunk; the int8 up / down products at an 8-lane
# decode step and at a 4096-token prefill
FLASH_HEADS = (16, 2, 128, 4096)      # q heads, kv heads, head_dim, prompt tokens
FLASH_CASES = {"causal": dict(sq=4096, window=0, q_offset=0),
               "window1024": dict(sq=4096, window=1024, q_offset=0),
               "chunk256": dict(sq=256, window=0, q_offset=3840)}
QMM_CASES = {"up_m8": (8, 2048, 11008), "down_m8": (8, 11008, 2048),
             "up_m4096": (4096, 2048, 11008), "down_m4096": (4096, 11008, 2048)}
FLASH_TOL = 2e-3      # abs and rel, the JAX kernel tests' tolerance
# copies of the codes rotated through for the cold-L2 times of the
# decode-sized products: 4 x 22.5 MB exceeds the H100's 50 MB L2, as one
# decode step reads each weight once
COLD_COPIES = 4


def qmm_tol(k: int) -> float:
    """quant_matmul's tolerance for bf16 x and bf16 out, relative to the
    largest |output|.  The products are exact on both sides; the tensor
    cores add each k16 step into the f32 accumulator with truncation,
    losing up to about one f32 ulp (2^-23) of the partial sum per step,
    and then each side rounds its f32 sum to bf16 once, which can differ
    by one bf16 ulp (at most 2^-7 of the value)."""
    return -(-k // 16) * 2.0 ** -23 + 2.0 ** -7


def attention_pairs(sq, sk, window, q_offset):
    """Unmasked (q, k) pairs of one head under the causal and window masks."""
    import numpy as np

    pos = q_offset + np.arange(sq)
    hi = np.minimum(sk, pos + 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def check_prefill_mlp(peaks, torch, ops, ref):
    """``flash_attention`` and ``quant_matmul`` at the shapes above.  No
    path of either package calls them: their public entry points are the
    path, driven once with the launch counters zeroed just before and read
    just after; then each output is held against the plain version, and
    kernel, plain version and library call are timed."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import quant_matmul as qmm_mod
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    bh, bkh, hd, sk = FLASH_HEADS
    qkv = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(bh, sk, hd, generator=gen).to(dtype).to(dev)
        k = torch.randn(bkh, sk, hd, generator=gen).to(dtype).to(dev)
        v = torch.randn(bkh, sk, hd, generator=gen).to(dtype).to(dev)
        for name, c in FLASH_CASES.items():
            qkv[name, dtype] = (q[:, -c["sq"]:].contiguous(), k, v)
    mlp = {}
    for name, (m, kdim, n) in QMM_CASES.items():
        mlp[name] = (torch.randn(m, kdim, generator=gen).bfloat16().to(dev),
                     torch.randint(-127, 128, (kdim, n), generator=gen,
                                   dtype=torch.int8).to(dev),
                     (torch.rand(n, generator=gen) * 4e-4 + 1e-5).to(dev))

    def attend(key):
        c = FLASH_CASES[key[0]]
        return flash_attention(*qkv[key], causal=True, window=c["window"],
                               q_offset=c["q_offset"], groups=bh // bkh)

    ops.reset_launches()
    outs = {key: attend(key) for key in qkv}
    outs.update({name: ops.quant_matmul(*mlp[name]) for name in mlp})
    torch.cuda.synchronize()
    launches = {name: ops.LAUNCHES[name] for name in ("flash_attention", "quant_matmul")}
    log(f"  prefill / MLP entry points: {len(qkv)} flash_attention and {len(mlp)} "
        f"quant_matmul calls, launches {launches}")
    if launches["flash_attention"] < len(qkv) or launches["quant_matmul"] < len(mlp):
        fail(f"flash_attention / quant_matmul launched {launches}, fewer than the "
             f"{len(qkv)} / {len(mlp)} calls made")

    cases = {}
    for key, got in outs.items():
        if isinstance(key, tuple):
            name, dtype = key
            c = FLASH_CASES[name]
            q, k, v = qkv[key]
            want = ref.flash_attention(q, k, v, causal=True, window=c["window"],
                                       q_offset=c["q_offset"], groups=bh // bkh)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            ok = bool((diff <= FLASH_TOL + FLASH_TOL * want.abs()).all())
            label = f"flash_attention {name} {str(dtype)[6:]}"
            pairs = bh * attention_pairs(c["sq"], sk, c["window"], c["q_offset"])
            elt = q.element_size()
            nbytes = q.numel() * elt + 2 * k.numel() * elt + got.numel() * 4
            rate = 2 if dtype == torch.bfloat16 else 1
            bnd, by = bound_ms(nbytes, 4 * hd * pairs, peaks, rate)
            row = dict(shape=f"q ({bh}, {c['sq']}, {hd}) k/v ({bkh}, {sk}, {hd}), window "
                             f"{c['window']}, q_offset {c['q_offset']}",
                       max_abs_err=err, tol=f"{FLASH_TOL} abs + {FLASH_TOL} rel",
                       ms=time_ms(lambda: attend(key), iters=20, warmup=3),
                       plain_ms=time_ms(lambda: ref.flash_attention(
                           q, k, v, causal=True, window=c["window"],
                           q_offset=c["q_offset"], groups=bh // bkh), iters=3, warmup=1),
                       bound_ms=bnd, bound_by=by, bound_rate=RATE_NAMES[rate],
                       flop=4 * hd * pairs, bytes=nbytes, library_ms=None,
                       design=fa_mod.design(dtype, hd))
            if name == "causal" and dtype == torch.bfloat16:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
                row["library_ms"] = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                                         enable_gqa=True), iters=20)
                row["library"] = ("scaled_dot_product_attention(is_causal=True, "
                                  "enable_gqa=True), bf16 out")
        else:
            label = f"quant_matmul {key}"
            x, codes, scale = mlp[key]
            m, kdim, n = QMM_CASES[key]
            want = ref.quant_matmul(x, codes, scale, torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            tol = qmm_tol(kdim)
            ok = got.dtype == torch.bfloat16 and err <= tol * top
            nbytes = x.numel() * 2 + codes.numel() + scale.numel() * 4 + got.numel() * 2
            bnd, by = bound_ms(nbytes, 2 * m * kdim * n, peaks, 2)
            row = dict(shape=f"x ({m}, {kdim}) bf16 @ codes ({kdim}, {n}) int8, bf16 out",
                       max_abs_err=err, tol=f"{tol:.6g} x max|out| ({top:.4g})",
                       ms=time_ms(lambda: ops.quant_matmul(x, codes, scale), iters=20),
                       plain_ms=time_ms(lambda: ref.quant_matmul(x, codes, scale,
                                                                 torch.bfloat16), iters=5),
                       bound_ms=bnd, bound_by=by, bound_rate=RATE_NAMES[2],
                       flop=2 * m * kdim * n, bytes=nbytes,
                       design=qmm_mod.design(x.dtype, m))
            cold = m <= qmm_mod.SMALL_M
            row.update(qmm_library(torch, x, codes, scale, cold))
            if cold:
                row["ms_graph"] = time_graph_ms(lambda: ops.quant_matmul(x, codes, scale))
                copies = [codes.clone() for _ in range(COLD_COPIES)]
                row["ms_cold"] = time_graph_ms(rotating(
                    [lambda c=c: ops.quant_matmul(x, c, scale) for c in copies]))
                del copies
        if not torch.isfinite(got).all() or not ok:
            fail(f"{label} disagrees with its plain version (max_abs_err {err:.3e})")
        cases[label] = row
        lib = (f", library {row['library_ms']:.4f} ms"
               if row.get("library_ms") is not None else "")
        if "dense_bf16_ms" in row:
            lib += f" (bf16 matmul on the dequantized weight {row['dense_bf16_ms']:.4f} ms)"
        if "ms_cold" in row:
            lib += (f"; in a CUDA graph: kernel {row['ms_graph']:.4f} ms warm; L2-cold "
                    f"({COLD_COPIES} copies of the weight): kernel {row['ms_cold']:.4f} ms, "
                    f"library {row['library_ms_cold']:.4f} ms, bf16 matmul "
                    f"{row['dense_bf16_ms_cold']:.4f} ms")
        log(f"  {label} [{row['shape']}, {row['design']}]: max_abs_err {err:.3e} "
            f"(tol {row['tol']}), "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms{lib}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_rate']})")
    del outs, qkv, mlp
    torch.cuda.empty_cache()

    rows = {}
    for kernel, head, source, replaces in (
            ("flash_attention", "flash_attention causal bfloat16",
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:84"),
            ("quant_matmul", "quant_matmul up_m4096",
             "src/repro_torch/kernels/csrc/quant_matmul_sm90.cu",
             "src/repro/kernels/quant_matmul.py:40")):
        mine = {k: v for k, v in cases.items() if k.startswith(kernel)}
        top = mine[head]
        rows[kernel] = dict(route="cuda", source=source, replaces=replaces,
                            max_abs_err=max(v["max_abs_err"] for v in mine.values()),
                            ms=top["ms"], plain_ms=top["plain_ms"],
                            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                            bound_rate=top["bound_rate"], library_ms=top["library_ms"],
                            headline=head, cases=mine)
    return rows, launches


def qmm_library(torch, x, codes, scale, cold=False):
    """Yardsticks, timed only: ``torch._weight_int8pack_mm``, PyTorch's one
    call computing x @ (codes * scale) from int8 weights (it takes them as
    (N, K)), and a bf16 ``torch.matmul`` on the weight dequantized
    beforehand (``dense_bf16_ms``: the dense tensor-core rate on the same
    shape).  ``cold``: also each rotated over ``COLD_COPIES`` copies of its
    weight in a CUDA graph (``*_ms_cold``), as the kernel is."""
    packed, s = codes.t().contiguous(), scale.to(x.dtype)
    w = (codes.float() * scale[None, :]).to(x.dtype)
    row = dict(library_ms=time_ms(lambda: torch._weight_int8pack_mm(x, packed, s),
                                  iters=5, warmup=1),
               library="torch._weight_int8pack_mm (weight (N, K) int8)",
               dense_bf16_ms=time_ms(lambda: torch.matmul(x, w), iters=20))
    if cold:
        packs = [packed.clone() for _ in range(COLD_COPIES)]
        row["library_ms_cold"] = time_graph_ms(rotating(
            [lambda p=p: torch._weight_int8pack_mm(x, p, s) for p in packs]), iters=8, reps=2)
        del packs
        ws = [w.clone() for _ in range(COLD_COPIES)]
        row["dense_bf16_ms_cold"] = time_graph_ms(rotating(
            [lambda w=w: torch.matmul(x, w) for w in ws]))
    return row


def store_leaf_check(codes, scale, torch, ops):
    """``quant_matmul`` on a real int8 store leaf (the int8 gateway's unit
    0 ``ffn/w_up``) against x @ masked_dequant(codes, scale, []), the
    weight the gateway's full-tier view serves."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    w = ops.masked_dequant(codes, scale, [], out_dtype=torch.float32)
    worst = 0.0
    for m in (8, 4096):
        x = torch.randn(m, codes.shape[0], generator=gen).bfloat16().to(codes.device)
        got = ops.quant_matmul(x, codes, scale)
        want = (x.float() @ w).bfloat16()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        tol = qmm_tol(codes.shape[0])
        log(f"  quant_matmul on the int8 store's unit-0 ffn/w_up {tuple(codes.shape)}, "
            f"M={m}: max_abs_err {err:.3e} vs x @ masked_dequant (tol {tol:.6g} x "
            f"max|out| {top:.4g})")
        if not torch.isfinite(got).all() or err > tol * top:
            fail("quant_matmul disagrees with x @ masked_dequant on the store leaf")
        worst = max(worst, err / top)
    return worst


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
    """Build both tiers' views (each timed by ``view_build``), then drain
    one request stream; returns its requests and timings."""
    from repro_torch.kernels import ops

    views = {}
    for tier in ("full", "free"):                  # build the views first
        _, views[tier] = view_build(torch, ops, lambda: gw.view_for(tier))
        v = views[tier]
        log(f"  {label}: view of tier {tier} built in {v['host_s']:.3f} s "
            f"({v['device_ms']:.2f} ms on the stream, {v['launches']} masked_dequant "
            f"launches, peak {v['peak_gb']:.2f} GB, {v['peak_above_gb']:.2f} GB above "
            f"the weights)")
    t_views = sum(v["host_s"] for v in views.values())
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
    return reqs, dict(views_s=t_views, views=views, serve_s=t_run,
                      tokens=m["tokens_generated"], decode_steps=m["decode_steps"],
                      prefill_chunks=m["prefill_chunks"])


def record_rows(gw):
    """Keep, on the card, every logits row a token of ``gw``'s stream is
    sampled from (the gateway's own scores), keyed by (request id, token
    index); a row recomputed after a preemption replaces the earlier one.
    Costs one device copy a step."""
    rows = {}
    sample = gw._sample

    def recorded(logits, reqs):
        kept = logits[: len(reqs)].clone()
        for i, r in enumerate(reqs):
            rows[(r.rid, len(r.out_tokens))] = kept[i]
        return sample(logits, reqs)

    gw._sample = recorded
    return rows


def stream_parts(kernel_reqs, plain_reqs, kernel_rows, plain_rows, vocab):
    """For each request, the first step at which the kernel path's and
    the plain path's greedy tokens part (None: they never do); there,
    from both paths' own logits rows at that step over the ``vocab``
    real ids (the same tokens came before it), the plain path's gap
    between its token and the kernel path's, the kernel path's gap the
    other way, the lane's max |logit diff| and the plain row's max
    |logit|.  Later tokens continue different texts."""
    parts = []
    for rk, rp in zip(kernel_reqs, plain_reqs):
        t = next((i for i, (a, b) in enumerate(zip(rk.out_tokens, rp.out_tokens))
                  if a != b), None)
        if t is None:
            parts.append(dict(request=rk.rid, step=None))
            continue
        k = kernel_rows[(rk.rid, t)][:vocab].float()
        p = plain_rows[(rp.rid, t)][:vocab].float()
        kt, pt = rk.out_tokens[t], rp.out_tokens[t]
        if (int(k.argmax()), int(p.argmax())) != (kt, pt):
            fail(f"request {rk.rid} step {t}: the recorded logits rows do not give "
                 f"the tokens the gateways emitted")
        parts.append(dict(request=rk.rid, step=t, kernel_token=kt, plain_token=pt,
                          plain_gap=(p[pt] - p[kt]).item(), kernel_gap=(k[kt] - k[pt]).item(),
                          lane_max_abs_diff=(k - p).abs().max().item(),
                          plain_max_abs=p.abs().max().item()))
    return parts


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
    if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
        fail("decode logits are not finite")
    diff = (out[0] - out[1]).abs()
    err = diff.max().item()
    scale = out[1].abs().max().item()
    top2 = out[1].topk(2, dim=-1)
    flips = []                        # lanes whose argmax differs
    for i in range(len(reqs)):
        kernel_tok, plain_tok = int(out[0][i].argmax()), int(top2.indices[i, 0])
        if kernel_tok != plain_tok:
            flips.append(dict(lane=i, plain_token=plain_tok, kernel_token=kernel_tok,
                              plain_top2_gap=(top2.values[i, 0] - top2.values[i, 1]).item(),
                              plain_gap_to_kernel_token=(
                                  out[1][i, plain_tok] - out[1][i, kernel_tok]).item(),
                              lane_max_abs_diff=diff[i].max().item()))
    return err, scale, len(reqs) - len(flips), len(reqs), tier, flips


# ------------------------------------------------------------ telemetry
# the series read back from the Prometheus page, against metrics()
PROM_READBACK = {"serving_tokens_generated_total": "tokens_generated",
                 "serving_decode_steps_total": "decode_steps",
                 "serving_prefill_chunks_total": "prefill_chunks",
                 "serving_requests_completed_total": "completed",
                 "serving_prefix_tokens_reused_total": "prefix_tokens_reused"}


def prom_values(text):
    """Sample lines of a Prometheus page: series (with labels) -> value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def telemetry_report(label, gw):
    """Validate what ``gw`` recorded (the Chrome trace, the metrics()
    schema, the Prometheus page against the counters) and print the six
    latency histograms.  Any failure fails the run."""
    from repro_torch.serving import validate_chrome_trace, validate_gateway_metrics

    try:
        events = validate_chrome_trace(gw.chrome_trace())
    except ValueError as e:
        fail(f"{label}: chrome_trace() is not a valid trace: {e}")
    m = gw.metrics()
    try:
        # decode_path.kernels: the port's one key outside the JAX schema
        validate_gateway_metrics(m, extra=("decode_path.kernels",))
    except AssertionError as e:
        fail(f"{label}: metrics() fails the gateway schema: {e}")
    prom = prom_values(gw.render_prometheus())
    read = {}
    for series, key in PROM_READBACK.items():
        read[series] = prom[f'{series}{{model="{gw.model}"}}']
        if read[series] != m[key]:
            fail(f"{label}: {series} reads {read[series]}, metrics() {key} {m[key]}")
    hist = {k: dict(count=v["count"], p50_ms=1e3 * v["p50"], p99_ms=1e3 * v["p99"],
                    sum_s=v["sum"]) for k, v in m["latency"].items()}
    audit = {}
    for e in gw.audit_events():
        audit[e["event"]] = audit.get(e["event"], 0) + 1
    log(f"  {label}: chrome_trace valid ({len(events)} events, {len(gw.tracer.events)} on "
        f"the tape), metrics() passes validate_gateway_metrics; audit {audit}")
    log(f"  {label}: histograms (host clock; count, p50 / p99 ms): " + "; ".join(
        f"{k} {h['count']}, {h['p50_ms']:.2f} / {h['p99_ms']:.2f}" for k, h in hist.items()))
    log(f"  {label}: read back from render_prometheus(): "
        + ", ".join(f"{k} {v:g}" for k, v in read.items()))
    return dict(trace_events=len(events), histograms=hist, prometheus=read, audit=audit)


def busy_union(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur = 0.0, None
    for a, b in sorted((max(lo, a), min(hi, b)) for a, b in intervals if b > lo and a < hi):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def profile_window(label, fn, torch, steps):
    """Run ``fn`` (``steps`` scheduler steps, then a synchronize) under
    torch.profiler with CPU and CUDA activities.  Returns the window's
    length, the union of its device intervals (kernels, copies, sets) as
    a share of it, kernel launches per step and the five kernels with
    the most device time; None when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = ROOT / "build" / "profiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{label}.json"
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_window"):
            fn()
            sync()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == "chip_smoke_window"
           and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not win or not dev:
        log(f"  profile {label}: the trace holds no device events (window "
            f"{len(win)}); device busy share not measured")
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    busy = busy_union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev], lo, hi)
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + float(e["dur"]), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    most = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    out = dict(window_ms=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
               busy_share=busy / (hi - lo), steps=steps,
               kernel_launches_per_step=len(kernels) / steps,
               copies_and_sets_per_step=(len(dev) - len(kernels)) / steps,
               kernel_ms_per_step=sum(float(e["dur"]) for e in kernels) / 1e3 / steps,
               top_kernels=[dict(name=n[:120], ms=t / 1e3, launches=c)
                            for n, (t, c) in top],
               most_launched=[dict(name=n[:120], ms=t / 1e3, launches=c)
                              for n, (t, c) in most])
    log(f"  profile {label} ({steps} step(s), torch.profiler CPU+CUDA, trace "
        f"{path.relative_to(ROOT)}): window {out['window_ms']:.2f} ms, device busy "
        f"{out['device_busy_ms']:.2f} ms = {100 * out['busy_share']:.1f}% (union of kernel, "
        f"copy and set intervals), {out['kernel_launches_per_step']:.0f} kernel launches and "
        f"{out['copies_and_sets_per_step']:.0f} copies/sets per step, kernel time "
        f"{out['kernel_ms_per_step']:.2f} ms per step")
    for title, rows in (("most device time", out["top_kernels"]),
                        ("most launches", out["most_launched"])):
        log(f"    the five kernels with the {title} (ms over the window, launches):")
        for k in rows:
            log(f"    {k['ms']:8.3f} ms  {k['launches']:5d} x  {k['name']}")
    return out


def decode_profile(gw, cfg, np, torch, steps=8):
    """Bring phase 3's stream to a steady decode (every lane admitted and
    decoding, nothing prefilling) on ``gw``, time ``steps`` scheduler
    steps (host clock, ending in a synchronize), then profile the next
    ``steps``.  The profiler's own host cost lengthens its window, so the
    device time it records is also given as a share of the unprofiled
    steps' time.  Leaves the stream mid-flight."""
    gw.__dict__.pop("_sample", None)           # drop record_rows's per-step copy
    submit_all(gw, cfg, np)
    while not (len(gw.scheduler.running) == gw.max_lanes and all(
            r.state.value == "running" for r in gw.scheduler.running)):
        if gw.step() is None:
            fail("profile: the stream drained before every lane decoded")
    kinds = []
    sync()
    t0 = time.perf_counter()
    kinds.extend(gw.step().kind for _ in range(steps))
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0) / steps
    prof = profile_window("decode_steps", lambda: kinds.extend(
        gw.step().kind for _ in range(steps)), torch, steps)
    if kinds != ["decode"] * (2 * steps):
        fail(f"profile: the windows ran {kinds}, not {2 * steps} decode steps")
    if prof is not None:
        prof["unprofiled_ms_per_step"] = plain_ms
        prof["busy_share_of_unprofiled"] = prof["device_busy_ms"] / steps / plain_ms
        log(f"  profile decode_steps: {steps} unprofiled steps before it took {plain_ms:.2f} ms "
            f"each (host clock, synchronized); the profiled device time "
            f"{prof['device_busy_ms'] / steps:.2f} ms a step is "
            f"{100 * prof['busy_share_of_unprofiled']:.1f}% of that")
    return prof


# ------------------------------------------------------------ phase 3b
# the shared-prefix stream: one 48-token system prefix (three full
# blocks) and an own suffix of 1-16 tokens per request, alternating
# tiers, then exact repeats of four earlier prompts (a full match capped
# at len - 1, and the CoW of a partial tail at the first decode); served
# in two waves, the first one request per tier, so the second finds
# both tiers' prefixes cached
SYS_TOKENS = 48
SHARED_N = 16
REPEATS = [0, 1, 2, 5]
SHARED_NEW = 16
# num_blocks of run (c): 2 of the 8 lanes' worth of 16-token blocks, so
# retained chains are evicted and running requests preempted
SMALL_POOL = 12


def shared_stream(cfg, np):
    """(tier, prompt) pairs of the shared-prefix stream, from ``SEED``."""
    rng = np.random.default_rng(SEED + 6)
    head = rng.integers(0, cfg.vocab_size, SYS_TOKENS, dtype=np.int32)
    out = []
    for i in range(SHARED_N):
        tail = rng.integers(0, cfg.vocab_size, 1 + (7 * i) % 16, dtype=np.int32)
        out.append(("free" if i % 2 else "full", np.concatenate([head, tail])))
    return out + [out[i] for i in REPEATS]


def guard_decode_writes(gw):
    """Fail the run if a decode step's write target (block ``pos // bs``
    of a lane) is shared when the step launches: ``_grow_block_tables``
    must have copied it first.  Returns the count of checked writes."""
    grow = gw._grow_block_tables
    checked = [0]

    def guarded(reqs):
        keep = grow(reqs)
        for r in keep:
            b = r.blocks[r.pos // gw.pool.block_size]
            if gw.pool.allocator.refcount(b) != 1:
                fail(f"request {r.rid}: decode would write block {b} with "
                     f"{gw.pool.allocator.refcount(b)} references")
            checked[0] += 1
        return keep

    gw._grow_block_tables = guarded
    return checked


def prefix_run(label, gw, stream, np, tier=None):
    """Serve ``stream`` (every request in ``tier`` when given) in its two
    waves; every request must finish and, after the drain, the allocator
    must hold only the prefix tree's references.  Returns the requests,
    their logits rows and a summary."""
    for t in ({tier} if tier else {t for t, _ in stream}):
        gw.view_for(t)                     # views first, as in phase 3
    checked = guard_decode_writes(gw)
    rows = record_rows(gw)
    reqs = []
    t0 = time.perf_counter()
    for wave in (stream[:2], stream[2:]):
        reqs += [gw.submit(p, license=tier or t, max_new_tokens=SHARED_NEW)
                 for t, p in wave]
        gw.run()
    sync()
    dt = time.perf_counter() - t0
    bad = [r.rid for r in reqs if r.state.value != "done"
           or len(r.out_tokens) != SHARED_NEW]
    if bad:
        fail(f"{label}: requests {bad} did not finish")
    m = gw.metrics()
    pc = m["prefix_cache"]
    held = gw.pool.allocator.num_held
    if held != (pc["retained_blocks"] if pc["enabled"] else 0) or \
            (pc["enabled"] and held != pc["cached_blocks"]):
        fail(f"{label}: after the drain the allocator holds {held} blocks, "
             f"the prefix tree {pc}")
    steps = m["decode_steps"] + m["prefill_chunks"]
    san = gw.sanitizer
    if san is not None and san.shadow != dict(gw.pool.allocator._ref):
        fail(f"{label}: the sanitizer's shadow refcounts differ from the allocator's")
    out = dict(serve_s=dt, tokens=m["tokens_generated"],
               tokens_per_s=m["tokens_generated"] / dt, steps=steps,
               ms_per_step=1e3 * dt / steps, decode_writes_checked=checked[0],
               **{k: m[k] for k in ("decode_steps", "prefill_chunks",
                                    "prefill_lane_tokens", "prefix_tokens_reused",
                                    "cow_copies", "preempted", "max_blocks_in_use")},
               prefix_cache=pc,
               sanitizer=None if san is None else dict(
                   shadow_blocks=len(san.shadow), step_shapes=san.retrace.stats()))
    log(f"  {label}: {len(reqs)} requests, {out['tokens']} tokens in {dt:.2f} s "
        f"({out['tokens_per_s']:.1f} tokens/s, {out['ms_per_step']:.1f} ms per scheduler "
        f"step over {steps}); prefill_chunks {out['prefill_chunks']}, prefill_lane_tokens "
        f"{out['prefill_lane_tokens']}, prefix_tokens_reused {out['prefix_tokens_reused']}, "
        f"cow_copies {out['cow_copies']}, preempted {out['preempted']}, decode writes "
        f"checked private {checked[0]}")
    log(f"  {label}: prefix_cache {json.dumps(pc)}")
    if san is not None:
        log(f"  {label}: sanitized (shadow refcounts on every allocator call, "
            f"check_decode_writes before each decode, check_drained at each drain): "
            f"clean; {len(san.shadow)} blocks held at the end, step shapes "
            f"{san.retrace.stats()}")
    return reqs, rows, out


def near_ties(label, reqs, ref_reqs, rows, ref_rows, vocab):
    """Greedy tokens of ``reqs`` against the cold run's: identical, or
    each request's first parting a near-tie by phase 4's rule (the cold
    run's gap between the two tokens below the lane's max |logit diff|,
    and that diff within 0.05 x max(|logit|, 1) of the cold row)."""
    parts = stream_parts(reqs, ref_reqs, rows, ref_rows, vocab)
    split = [p for p in parts if p["step"] is not None]
    for p in split:
        p["tol"] = 0.05 * max(p["plain_max_abs"], 1.0)
        log(f"  {label}: request {p['request']} parts from the cold run at step "
            f"{p['step']}: token {p['kernel_token']} vs {p['plain_token']}; cold gap "
            f"{p['plain_gap']:.4f}, lane max |logit diff| {p['lane_max_abs_diff']:.4f} "
            f"(tol {p['tol']:.4f})")
    wide = [p["request"] for p in split
            if not (p["plain_gap"] < p["lane_max_abs_diff"] <= p["tol"])]
    if wide:
        fail(f"{label}: requests {wide} part from the cold run at a step that is not "
             f"a near-tie")
    same = sum(p["step"] is None for p in parts)
    log(f"  {label}: greedy tokens identical to the cold run on {same}/{len(parts)} "
        f"requests, every parting a near-tie")
    return parts


def prefix_phase(cfg, params, tiers, np, device="cuda"):
    """Phase 3b: the shared-prefix stream (a) with the prefix cache, (b)
    without, (c) with it on a pool of ``SMALL_POOL`` blocks, and (d) with
    it through int8 views; (a) and (c) sanitized.  Returns the summary of
    each run."""
    from repro_torch.serving import LicensedGateway

    stream = shared_stream(cfg, np)
    runs, got = {}, {}
    for name, kw in (("a_prefix", dict(sanitize=True)), ("b_cold", dict(prefix_cache=False)),
                     ("c_small_pool", dict(num_blocks=SMALL_POOL, sanitize=True)),
                     ("d_int8", dict(quantized=True, materialize_int8_views=True))):
        gw = LicensedGateway(cfg, params, tiers=tiers, device=device, **kw, **GEOMETRY)
        got[name] = prefix_run(f"3b ({name})", gw, stream, np)
        runs[name] = got[name][2]
        del gw
        gc.collect()
    a, b, c, d = (runs[k] for k in ("a_prefix", "b_cold", "c_small_pool", "d_int8"))
    if not (a["prefix_tokens_reused"] > 0 and a["cow_copies"] > 0
            and a["prefill_lane_tokens"] < b["prefill_lane_tokens"]):
        fail(f"3b: the prefix cache saved nothing: {a} against {b}")
    if not (c["prefix_cache"]["evicted_blocks"] > 0 and c["preempted"] > 0):
        fail(f"3b: the small pool neither evicted nor preempted: {c}")
    if not (d["prefix_tokens_reused"] > 0 and d["cow_copies"] > 0):
        fail(f"3b: the int8 run reused nothing: {d}")
    cold = got["b_cold"]
    for name in ("a_prefix", "c_small_pool"):
        reqs, rows, _ = got[name]
        runs[name]["parts"] = near_ties(f"3b ({name})", reqs, cold[0], rows, cold[1],
                                        cfg.vocab_size)
    log(f"  3b: prefill lane-tokens {a['prefill_lane_tokens']} with the cache against "
        f"{b['prefill_lane_tokens']} without ({b['prefill_lane_tokens'] - a['prefill_lane_tokens']} "
        f"saved); {a['ms_per_step']:.1f} against {b['ms_per_step']:.1f} ms per step, "
        f"{a['serve_s']:.2f} against {b['serve_s']:.2f} s")
    del got
    return runs


# ------------------------------------------------------------ phase 7
CAL_PROMPTS = (16, 64)                 # eval_fn's teacher-forced batch
CAL = dict(k_intervals=10, interval_mode="quantile", refine_steps=4)
CAL_TARGET, CAL_TOL = 0.9, 0.02


def agreement_eval(cfg, params, np, torch, device="cuda"):
    """``eval_fn`` of Algorithm 1: the top-1 agreement of a weight set's
    argmax with ``params``' own over seeded teacher-forced prompts,
    through ``models.model.forward`` with no cache.  Returns the
    function and the list its call times go to."""
    from repro_torch.models.model import forward

    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, CAL_PROMPTS,
                                         dtype=np.int32)).to(device)

    def top1(p):
        with torch.no_grad():
            return forward(p, cfg, toks)[0][..., : cfg.vocab_size].argmax(-1)

    want = top1(params)
    times = []

    def eval_fn(p):
        t0 = time.perf_counter()
        acc = (top1(p) == want).float().mean().item()
        times.append(time.perf_counter() - t0)
        return acc

    return eval_fn, times


def same_bits(a, b, torch):
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and bool(torch.equal(a.view(bits), b.view(bits)))


def calibration_phase(cfg, params, np, torch, device="cuda"):
    """Phase 7: Algorithm 1 on ``params``, the tier's checks, then the
    shared-prefix stream served in it with the prefix cache."""
    from repro_torch.core import licensing
    from repro_torch.core.pytree_io import flatten_params
    from repro_torch.serving import LicensedGateway

    out = {}
    flat = flatten_params(params)
    maskable = [n for n, t in flat.items()
                if not licensing.is_dynamics_param(n) and t.ndim >= 2]
    leaves = [flat[n] for n in maskable]
    n_weights = sum(t.numel() for t in leaves)
    # the count route on the card against one sort, on a real leaf's slice
    probe = [flat["units/b0/mixer/wq"][0]]
    ks = np.linspace(0, probe[0].numel() - 1, 11).astype(np.int64)
    if licensing._order_stats_16bit(probe, ks) != licensing._order_stats_sorted(probe, ks):
        fail("7: the bit-pattern count and a sort give different order statistics")
    sync()
    t0 = time.perf_counter()
    edges = licensing.magnitude_quantiles(leaves, np.linspace(0.0, 1.0, CAL["k_intervals"] + 1))
    sync()
    out["edges_s"] = time.perf_counter() - t0
    out["edges"] = edges.tolist()
    log(f"  quantile edges of {n_weights} magnitudes over {len(leaves)} leaves "
        f"({cfg.dtype_name}) in {out['edges_s']:.3f} s: {out['edges']}")

    eval_fn, times = agreement_eval(cfg, params, np, torch, device)
    sync()
    t0 = time.perf_counter()
    tier, trace = licensing.calibrate_license(params, eval_fn, CAL_TARGET,
                                              tolerance=CAL_TOL, tier_name="cal", **CAL)
    sync()
    out.update(calibrate_s=time.perf_counter() - t0, evals=len(times),
               eval_ms_median=1e3 * float(np.median(times)),
               eval_ms_max=1e3 * max(times), steps=len(trace),
               layer_order=maskable, accuracy=tier.accuracy,
               trace=[dict(interval=s.interval, layer=s.layer, accuracy=s.accuracy)
                      for s in trace],
               masks={k: [list(iv) for iv in v] for k, v in tier.masks.items()})
    log(f"  calibrate_license (target {CAL_TARGET}, tolerance {CAL_TOL}, {CAL}): "
        f"{len(trace)} steps, {len(times)} evals of {CAL_PROMPTS[0]} x {CAL_PROMPTS[1]} "
        f"tokens (median {out['eval_ms_median']:.1f} ms, max {out['eval_ms_max']:.1f} ms), "
        f"{out['calibrate_s']:.2f} s in all; layer order {maskable}")
    for s in trace:
        log(f"    cut [{s.interval[0]:.6g}, {s.interval[1]:.6g}) on {s.layer}: "
            f"agreement {s.accuracy:.4f}")
    reached = tier.accuracy <= CAL_TARGET + CAL_TOL
    unreachable = len(trace) == CAL["k_intervals"] * len(maskable)
    if not (reached or unreachable):
        fail(f"7: the tier's agreement {tier.accuracy} misses the target "
             f"{CAL_TARGET} + {CAL_TOL} and the trace did not exhaust the intervals")
    again = eval_fn(licensing.apply_license(params, tier))
    if again != tier.accuracy:
        fail(f"7: eval_fn(apply_license(params, tier)) = {again}, the tier "
             f"says {tier.accuracy}")
    out["license_stats"] = licensing.license_stats(params, tier)
    log(f"  tier 'cal': agreement {tier.accuracy:.4f} (re-evaluated {again:.4f}), "
        f"license_stats {out['license_stats']}, masks {out['masks']}")

    gw = LicensedGateway(cfg, params, tiers={"cal": tier}, device=device, **GEOMETRY)
    want = flatten_params(licensing.apply_license(params, tier))
    view = flatten_params(gw.view_for("cal"))
    bad = [n for n in want if not same_bits(view[n], want[n], torch)]
    if bad or set(view) != set(want):
        fail(f"7: the gateway's view of the calibrated tier differs from "
             f"apply_license in {bad[:5]}")
    del want, view
    log("  the gateway's float view of tier 'cal' equals apply_license bit for bit")
    stream = shared_stream(cfg, np)
    _, _, served = prefix_run("7 (tier cal, prefix cache)", gw, stream, np, tier="cal")
    if served["prefix_cache"]["hits"] <= 0:
        fail("7: the shared-prefix stream in the calibrated tier had no prefix hits")
    out["served"] = served
    del gw
    gc.collect()
    return out


# ------------------------------------------------------------ phase 5 / 6
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_v2(v1, units, torch):
    """v1 with ``units`` changed: norm scales and q/k/v biases (rows-mode
    layers) redrawn, and 1% of the entries of each block matrix slice
    (chunk-mode layers) replaced.  Untouched layers are shared with v1."""
    gen = torch.Generator().manual_seed(SEED + 2)
    blk = v1["units"]["b0"]
    new = {"norm1": {}, "norm2": {}, "mixer": {}, "ffn": {}}
    for grp, key in (("norm1", "norm_scale"), ("norm2", "norm_scale"),
                     ("mixer", "bq"), ("mixer", "bk"), ("mixer", "bv")):
        w = blk[grp][key].clone()
        base = 1.0 if grp.startswith("norm") else 0.0
        w[units] = (base + 0.05 * torch.randn(w[units].shape, generator=gen)).to(w.dtype)
        new[grp][key] = w
    for grp, key in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
                     ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")):
        w = blk[grp][key].clone()
        sl = w[units].reshape(-1)                  # a copy of the slice
        hit = torch.randperm(sl.numel(), generator=gen)[: sl.numel() // 100]
        sl[hit] = (torch.randn(hit.numel(), generator=gen) * 0.02).to(w.dtype)
        w[units] = sl.reshape(w[units].shape)
        new[grp][key] = w
    units_new = {g: {**blk[g], **new[g]} for g in blk}
    return {**v1, "units": {"b0": units_new}}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def same_weights(got, want, torch):
    """Names of the layers where the card's tensors differ from the host
    reference (compared on the card, one layer at a time)."""
    want_flat = dict(flat_leaves(want))
    bad = [name for name, t in flat_leaves(got)
           if not torch.equal(t, want_flat[name].to(t.device))]
    return bad + sorted(set(want_flat) - {n for n, _ in flat_leaves(got)})


class Timed:
    """Host-clock sums around library calls of the boot pull (each ends
    in a device synchronize), installed on the modules that call them."""

    def __init__(self):
        self.s = {}
        self._undo = []

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def update_phase(label, cfg, gw_kw, torch, np, *, device="cuda", ref_tokens=None,
                 max_step_bytes=16 << 20, profile_stage=False):
    """Publish v1, boot a gateway from the server, serve the stream, and
    stage v2 mid-stream; every check of phases 5/6.  With
    ``profile_stage`` the third scheduler step with a stage step rides
    under torch.profiler (and is left out of the step times).  Returns a
    summary."""
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import transport as transport_lib
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.core.protocol import LicenseServer
    from repro_torch.core.weightstore import WeightStore
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import LicensedGateway
    from repro_torch.serving.quantized import quantize_serving_params

    out = {}
    u = cfg.pattern_units
    units = list(range(max(0, u - 4), u))
    v1 = tree_map(lambda t: t.cpu(), init_params(cfg, seed=SEED, device=device))
    v2 = make_v2(v1, units, torch)
    # chunk pages stored raw: random bf16 weights do not compress, and
    # zlib over the 6.8 GB model would cost about a minute of host time
    server = LicenseServer(WeightStore(":memory:", compress_chunks=False))
    t0 = time.perf_counter()
    server.publish("lm", v1, tag="v1")
    server.publish_tier("lm", LicenseTier(name="free", masks=FREE_TIER))
    out["publish_v1_s"] = time.perf_counter() - t0

    template = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), v1)
    timed = Timed()
    timed.wrap(server.store, "delta_since", "delta_query_s")
    timed.wrap(transport_lib, "packet_checksum", "checksums_s")
    timed.wrap(delta_lib, "to_tensor", "transfer_s")
    timed.wrap(ops, "delta_apply", "apply_s")
    t0 = time.perf_counter()
    try:
        gw = LicensedGateway.from_server(cfg, server, "lm", template, device=device,
                                         **gw_kw, **GEOMETRY)
        sync()
    finally:
        timed.restore()
    boot = time.perf_counter() - t0
    del template
    out["boot_pull"] = {"total_s": boot, **timed.s,
                        "other_s": boot - sum(timed.s.values()),
                        "wire_bytes": gw._client.bytes_downloaded}
    log(f"  {label}: boot pull {boot:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in timed.s.items())
        + f"), {gw._client.bytes_downloaded / 1e9:.2f} GB on the wire")
    bad = same_weights(gw._client.params, v1, torch)
    if bad:
        fail(f"{label}: boot pull differs from v1 in {bad[:5]}")
    log(f"  {label}: pulled weights equal v1 bit for bit "
        f"({sum(1 for _ in flat_leaves(v1))} layers)")

    for tier in ("full", "free"):    # views first, as in phase 3, so the
        gw.view_for(tier)           # step before the sync is a plain one
    reqs = submit_all(gw, cfg, np)
    steps = {"before": [], "during": [], "after": []}
    phases = {}
    flip_t = None
    profiled = {}

    def step():
        nonlocal flip_t
        when = ("during" if gw.sync_active else
                "before" if gw.version == 1 else "after")
        if gw.sync_active:
            phases[gw._stager.phase] = phases.get(gw._stager.phase, 0) + 1
            if (profile_stage and not profiled and gw._stager.phase == "stage"
                    and phases["stage"] == 3):
                acts = []
                profiled["profile"] = profile_window(
                    "stage_step", lambda: acts.append(LicensedGateway.step(gw)), torch, 1)
                span = [e for e in gw.tracer.events if e[3] == "stager:stage"][-1]
                profiled["stager_span_ms"] = 1e3 * span[5]
                log(f"  {label}: the profiled step's stager:stage span (host clock, no "
                    f"synchronize) {profiled['stager_span_ms']:.2f} ms")
                return acts[0]
        t = time.perf_counter()
        act = LicensedGateway.step(gw)
        sync()
        dt = time.perf_counter() - t
        if act is not None or when == "during":
            steps[when].append(dt)
        if flip_t is None and gw.version != 1:
            flip_t = time.perf_counter()
        return act

    gw.step = step                 # run() drives this timed step
    gw.step()
    t0 = time.perf_counter()
    server.publish("lm", v2, tag="v2")
    out["publish_v2_s"] = time.perf_counter() - t0
    wire0 = gw._client.bytes_downloaded
    t_begin = time.perf_counter()
    if not gw.begin_sync(max_step_bytes=max_step_bytes):
        fail(f"{label}: begin_sync found no newer version")
    out["begin_sync_s"] = time.perf_counter() - t_begin
    gw.run()
    sync()
    st = gw.metrics()["staged_update"]
    if flip_t is None or st["flips"] != 1 or gw.version != 2:
        fail(f"{label}: expected exactly one flip to v2, got {st['flips']} "
             f"(version {gw.version})")
    bad = [r.rid for r in reqs if r.version != 1 or r.state.value != "done"
           or len(r.out_tokens) != r.max_new_tokens]
    if bad:
        fail(f"{label}: in-flight requests {bad} left v1 or did not finish")
    if ref_tokens is not None and [r.out_tokens for r in reqs] != ref_tokens:
        fail(f"{label}: in-flight tokens differ from the update-free run")
    if gw.quantized:
        want = quantize_serving_params(tree_map(lambda t: t.to(device), v2))
        bad = same_weights(gw._weights[2], want, torch)
        del want
        if bad:
            fail(f"{label}: v2 int8 store differs from quantize_serving_params(v2) "
                 f"in {bad[:5]}")
    bad = same_weights(gw._client.params, v2, torch)
    if bad:
        fail(f"{label}: flipped weights differ from v2 in {bad[:5]}")
    # what the gateway recorded of the sync: one sync_begin and one
    # version_flip, one stager:<phase> span and h_stager observation a step
    from repro_torch.serving import validate_chrome_trace

    audit = {ev: len(gw.audit_events(ev)) for ev in ("sync_begin", "version_flip", "sync_abort")}
    if audit != {"sync_begin": 1, "version_flip": 1, "sync_abort": 0}:
        fail(f"{label}: the audit holds {audit}, not one sync_begin and one version_flip")
    spans = [e for e in gw.tracer.events if e[3].startswith("stager:")]
    span_phases = {}
    for e in spans:
        span_phases[e[3]] = span_phases.get(e[3], 0) + 1
    if {k[len("stager:"):]: v for k, v in span_phases.items()} != phases \
            or gw.h_stager.count != len(spans):
        fail(f"{label}: stager spans {span_phases} / h_stager {gw.h_stager.count} "
             f"do not match the steps {phases}")
    try:
        validate_chrome_trace(gw.chrome_trace())
    except ValueError as e:
        fail(f"{label}: chrome_trace() is not a valid trace: {e}")
    prof = profiled.get("profile")
    if prof is not None and steps["during"]:
        # the profiler lengthens its step; its device time against the
        # median unprofiled step during the sync
        med = 1e3 * float(np.median(steps["during"]))
        prof["busy_share_of_median_step"] = prof["device_busy_ms"] / med
        log(f"  {label}: the profiled stage step's device time {prof['device_busy_ms']:.2f} ms "
            f"is {100 * prof['busy_share_of_median_step']:.1f}% of the median synchronized "
            f"step during the sync ({med:.1f} ms)")
    stager_h = dict(count=gw.h_stager.count, p50_ms=1e3 * gw.h_stager.p50,
                    p99_ms=1e3 * gw.h_stager.p99, max_ms=1e3 * max(e[5] for e in spans),
                    spans_by_phase=span_phases, audit=audit, **profiled)
    misses = gw.views.misses
    late = [gw.submit(np.arange(1, 20, dtype=np.int32), license=t, max_new_tokens=4)
            for t in ("full", "free")]
    gw.run()
    if any(r.version != 2 or r.state.value != "done" for r in late) \
            or gw.views.misses != misses:
        fail(f"{label}: post-flip requests not served on v2 through prewarmed views")
    out.update(
        sync_steps_by_phase=phases, parts_applied=st["parts_applied"],
        bytes_applied=st["bytes_applied"], layers_touched=st["layers_touched"],
        layers_requantized=st["layers_requantized"],
        views_prewarmed=st["views_prewarmed"], wire=st["wire"],
        sync_wire_bytes=gw._client.bytes_downloaded - wire0,
        begin_to_flip_s=flip_t - t_begin,
        step_ms={k: {"n": len(v), "max": 1e3 * max(v) if v else None,
                     "median": 1e3 * float(np.median(v)) if v else None}
                 for k, v in steps.items()},
        stager_histogram=stager_h,
        tokens=[r.out_tokens for r in reqs])
    log(f"  {label}: v2 staged in {sum(phases.values())} steps {phases}, "
        f"{st['parts_applied']} parts, {st['bytes_applied'] / 1e6:.1f} MB applied, "
        f"{out['sync_wire_bytes'] / 1e6:.1f} MB on the wire; begin_sync "
        f"{out['begin_sync_s']:.2f} s, begin->flip {out['begin_to_flip_s']:.2f} s")
    sm = out["step_ms"]
    log(f"  {label}: longest scheduler step before the sync "
        f"{sm['before']['max']:.1f} ms, during {sm['during']['max']:.1f} ms "
        f"(median {sm['during']['median']:.1f} ms over {sm['during']['n']}), after "
        f"{sm['after']['max']:.1f} ms; in-flight requests stayed on v1, one flip, "
        f"v2 bit-exact, post-flip requests on prewarmed v2 views")
    log(f"  {label}: stager spans {span_phases}; h_stager (host clock around each "
        f"stager step, no synchronize) p50 {stager_h['p50_ms']:.2f}, p99 "
        f"{stager_h['p99_ms']:.2f} (bucket-interpolated), max {stager_h['max_ms']:.2f} ms over "
        f"{gw.h_stager.count}, "
        f"against the script's synchronized longest scheduler step during the sync "
        f"{sm['during']['max']:.1f} ms; audit: one sync_begin, one version_flip")
    del gw
    gc.collect()
    return out


def main() -> None:
    t_script = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    # the plain versions' f32 products in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    log("phase 2: prefill attention and int8 MLP products at qwen2.5-3b's shapes")
    prefill_rows, prefill_launches = check_prefill_mlp(peaks, torch, ops, ref)
    rows.update(prefill_rows)

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
    # the float stream three times: telemetry off, on (the default, and
    # the run phase 4 reads), off again; each run keeps the same per-step
    # copy of its logits rows (record_rows), so the runs differ only in
    # what telemetry records
    off_runs = []

    def serve_off(n):
        gw_off = LicensedGateway(cfg, params, tiers=tiers, telemetry=False, **GEOMETRY)
        record_rows(gw_off)
        reqs, t = serve(f"float views, telemetry off ({n})", gw_off, cfg, np, torch)
        if len(gw_off.tracer.events) or gw_off.audit_events() or gw_off.h_decode.count:
            fail("telemetry=False recorded events, audit records or observations")
        off_runs.append((reqs, t))

    serve_off(1)
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    kernel_rows = record_rows(gw)           # read in phase 4
    float_reqs, float_t = serve("float views", gw, cfg, np, torch)
    serve_off(2)
    gc.collect()
    if any([r.out_tokens for r in reqs] != [r.out_tokens for r in float_reqs]
           for reqs, _ in off_runs):
        fail("greedy tokens differ between telemetry on and off")
    off_ms = [1e3 * t["serve_s"] / (t["decode_steps"] + t["prefill_chunks"]) for _, t in off_runs]
    on_ms = 1e3 * float_t["serve_s"] / (float_t["decode_steps"] + float_t["prefill_chunks"])
    overhead = dict(on_ms_per_step=on_ms, off_ms_per_step=off_ms,
                    on_tokens_per_s=float_t["tokens"] / float_t["serve_s"],
                    off_tokens_per_s=[t["tokens"] / t["serve_s"] for _, t in off_runs],
                    overhead_pct=100 * (on_ms / (sum(off_ms) / 2) - 1))
    log(f"  telemetry on against off: {on_ms:.2f} against {off_ms[0]:.2f} / {off_ms[1]:.2f} ms "
        f"per step, {overhead['on_tokens_per_s']:.1f} against "
        f"{overhead['off_tokens_per_s'][0]:.1f} / {overhead['off_tokens_per_s'][1]:.1f} tokens/s: "
        f"overhead {overhead['overhead_pct']:+.2f}% of the mean off step (reported, not "
        f"gated); greedy tokens identical across the three runs")
    float_t["telemetry"] = telemetry_report("float views", gw)
    float_t["telemetry"]["on_off"] = overhead
    float_t["decode_profile"] = decode_profile(gw, cfg, np, torch)
    del gw, off_runs            # slot <-> gateway cycle: collect its views
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, quantized=True,
                         materialize_int8_views=True, **GEOMETRY)
    _, int8_t = serve("int8 views", gw, cfg, np, torch)
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    store = gw._weights[gw.version]
    leaf = store["units"]["b0"]["ffn"]["w_up"]
    leaf = (leaf["codes"][0].clone(), leaf["scale"][0].reshape(-1).clone())
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    rows["masked_dequant"]["cases"].update(
        view_cases(peaks, torch, ops, store, tiers["free"], cfg.dtype))
    del store
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(prefill_launches)
    rows["quant_matmul"]["store_leaf_rel_err"] = store_leaf_check(*leaf, torch, ops)
    del leaf

    # ---------------------------------------------------------- phase 3b
    log(f"phase 3b: the shared-prefix stream, {ARCH} at full width and depth")
    ops.reset_launches()
    prefix_runs = prefix_phase(cfg, params, tiers, np)
    prefix_launches = dict(ops.LAUNCHES)
    log(f"  launches on the shared-prefix path: {prefix_launches}")
    for name in ("paged_attention", "paged_decode_write", "masked_dequant"):
        if prefix_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the shared-prefix path")
    fingerprint = leaf_sums(params, torch)      # phase 7 re-creates these weights

    # ---------------------------------------------------------- phase 4
    log("phase 4: kernel path vs plain path")
    gw = LicensedGateway(cfg, params, tiers=tiers, **GEOMETRY)
    err, scale, same, n_lanes, tier, flips = decode_logits_check(gw, cfg, np, torch)
    # bf16 tolerance: the kernel returns f32 attention cast once to bf16,
    # the plain path casts probabilities to bf16 before the value product;
    # 36 layers of bf16 residual rounding separate the two
    tol = 0.05 * max(scale, 1.0)
    log(f"  one decode step ({n_lanes} lanes, tier {tier}): max |logit diff| "
        f"{err:.4f} vs max |logit| {scale:.3f} (tol {tol:.4f}); "
        f"argmax agrees on {same}/{n_lanes} lanes")
    if not err <= tol:
        fail("decode logits of the kernel path and the plain path disagree")
    # a lane whose argmax differs is a near-tie when the plain path's two
    # best logits lie closer than the step's max |logit diff|; a wider gap
    # would take more than rounding to flip, so it is a fault
    for f in flips:
        log(f"  lane {f['lane']}: kernel token {f['kernel_token']}, plain token "
            f"{f['plain_token']}; plain top-2 gap {f['plain_top2_gap']:.4f} (to the kernel's "
            f"token {f['plain_gap_to_kernel_token']:.4f}), lane max |logit diff| "
            f"{f['lane_max_abs_diff']:.4f}, step max |logit diff| {err:.4f}")
    wide = [f["lane"] for f in flips if not f["plain_gap_to_kernel_token"] < err]
    if wide:
        fail(f"argmax flips on lanes {wide} with a plain-path gap of at least the max "
             f"|logit diff| {err:.4f}: not a near-tie")
    log(f"  argmax flips: {len(flips)}, every one a near-tie (gap below {err:.4f})")
    del gw
    gc.collect()
    gw = LicensedGateway(cfg, params, tiers=tiers, decode_kernels=False, **GEOMETRY)
    plain_rows = record_rows(gw)
    plain_reqs, plain_t = serve("float views, plain decode path", gw, cfg, np, torch)
    agree = sum(a == b for r1, r2 in zip(float_reqs, plain_reqs)
                for a, b in zip(r1.out_tokens, r2.out_tokens))
    total = sum(len(r.out_tokens) for r in float_reqs)
    parts = stream_parts(float_reqs, plain_reqs, kernel_rows, plain_rows, cfg.vocab_size)
    del kernel_rows, plain_rows
    log(f"  greedy tokens equal between kernel and plain decode: {agree}/{total}; "
        f"first differing step per request (None: identical): "
        f"{[p['step'] for p in parts]}")
    # where a request's tokens part, both paths had the same tokens before:
    # a near-tie is a plain-path gap below that lane's |logit diff|, and the
    # diff itself within the decode step's tolerance above; a gap as wide as
    # the diff, or a wider diff, takes more than rounding
    split = [p for p in parts if p["step"] is not None]
    for p in split:
        log(f"  request {p['request']} parts at step {p['step']}: kernel token "
            f"{p['kernel_token']}, plain token {p['plain_token']}; plain-path gap "
            f"{p['plain_gap']:.4f} (kernel-path gap {p['kernel_gap']:.4f}), lane max "
            f"|logit diff| {p['lane_max_abs_diff']:.4f} (tol {tol:.4f})")
    wide = [p["request"] for p in split
            if not (p["plain_gap"] < p["lane_max_abs_diff"] <= tol)]
    if wide:
        fail(f"requests {wide} part at a step whose plain-path gap reaches the lane's "
             f"|logit diff|, or whose diff exceeds {tol:.4f}: not a near-tie")
    log(f"  requests parting: {len(split)}, every one at a near-tie")

    del gw, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 5
    log(f"phase 5: update path, {ARCH} at full width and depth")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    upd = update_phase("float gateway", cfg, {}, torch, np,
                       ref_tokens=[r.out_tokens for r in float_reqs], profile_stage=True)
    upd["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the process's peak resident host memory so far (ru_maxrss is in KiB)
    upd["host_maxrss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    log(f"  float gateway: in-flight tokens equal phase 3's update-free run; "
        f"max_memory_allocated {upd['max_memory_allocated_gb']:.1f} GB, "
        f"host peak RSS {upd['host_maxrss_gb']:.1f} GB")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    log(f"phase 6: update path on an int8 gateway, {ARCH} at full width, 4 units")
    torch.cuda.reset_peak_memory_stats()
    cfg4 = cfg.replace(num_layers=4)
    upd8 = update_phase("int8 gateway", cfg4,
                        dict(quantized=True, materialize_int8_views=True), torch, np)
    upd8["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    upd_launches = dict(ops.LAUNCHES)
    log(f"  launches on the update path: {upd_launches}")
    for name in ("delta_apply", "delta_apply_inplace"):
        if upd_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the update path")
        launches[name] = upd_launches[name]

    # ---------------------------------------------------------- phase 7
    log(f"phase 7: Algorithm 1 (calibrate_license) on phase 3's weights, {ARCH} at "
        f"full width and depth")
    params = init_params(cfg, seed=SEED, device="cuda")
    if leaf_sums(params, torch) != fingerprint:
        fail("7: init_params(seed) did not re-create phase 3's weights")
    ops.reset_launches()
    calib = calibration_phase(cfg, params, np, torch)
    calib_launches = dict(ops.LAUNCHES)
    log(f"  launches while serving the calibrated tier: {calib_launches}")
    for name in ("paged_attention", "paged_decode_write"):
        if calib_launches[name] <= 0:
            fail(f"kernel {name} was not launched serving the calibrated tier")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8
    kernels = [dict(name=name, launches=launches[name], **row)
               for name, row in rows.items()]
    for u in (upd, upd8):
        u.pop("tokens")
    log(f"whole script {time.perf_counter() - t_script:.1f} s (kernel build included)")
    log(json.dumps({"gateway": {"float": float_t, "int8": int8_t,
                                "plain_decode": plain_t,
                                "decode_logits_max_abs_err": err,
                                "decode_argmax_flips": flips, "stream_parts": parts},
                    "shared_prefix": {"runs": prefix_runs, "launches": prefix_launches},
                    "update": {"float_full_depth": upd, "int8_depth4": upd8},
                    "calibration": {**calib, "launches": calib_launches}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def leaf_sums(tree, torch):
    """One integer per leaf: the sum of its bit patterns (a fingerprint
    of the weights that needs no host copy)."""
    return [int(t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                .sum(dtype=torch.int64)) for t in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
