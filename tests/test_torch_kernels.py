"""The port's kernels against the JAX package's, on shared numpy inputs.

On the CPU every wrapper of ``repro_torch.kernels`` takes its plain
version; those are held against the JAX oracles (``repro.kernels.ref``)
and against the Pallas kernels run in interpret mode, as the JAX tests
run them.  Tolerances:

* ``paged_attention``: 1e-5 in f32 — the two frameworks reduce the
  softmax and the value product in different orders (the JAX tests hold
  the Pallas kernel to 2e-3, a tolerance sized for TPU dtypes);
* ``paged_decode_write``, ``masked_dequant`` and ``delta_apply``: exact
  — a copy with a cast, and f32 multiply / compare / select, leave no
  room for rounding differences (``masked_dequant`` is compared bit for
  bit, so a -0.0 for a +0.0 would fail).  The null block's content is
  garbage by contract and is never compared.

The cases marked ``gpu`` hold each CUDA kernel against its plain version
on the card; they skip on a machine without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.kernels.paged_attention import paged_decode_write as jax_paged_decode_write

from repro_torch.kernels import ops, ref
from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.masked_dequant import masked_dequant
from repro_torch.kernels.paged_attention import paged_attention, paged_decode_write
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _attention_case(seed, b, h, kh, hd, bs, t, lens, dead_entries=None):
    """q/k/v blocks, disjoint tables, ragged lens; dead table entries (past
    ceil(len/bs)) rewritten to arbitrary blocks when given."""
    r = np.random.default_rng(seed)
    p = b * t + 3
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    kb = r.standard_normal((p, bs, kh, hd)).astype(np.float32)
    vb = r.standard_normal((p, bs, kh, hd)).astype(np.float32)
    tables = r.permutation(p)[: b * t].reshape(b, t).astype(np.int32)
    if dead_entries is not None:
        for i, n in enumerate(lens):
            live = -(-n // bs)
            tables[i, live:] = r.integers(0, p, t - live) if dead_entries else 0
    return q, kb, vb, tables, np.asarray(lens, np.int32)


ATTENTION_CASES = {
    # GQA, 4 query heads per kv head, ragged lens off block multiples
    "gqa_ragged": dict(b=3, h=8, kh=2, hd=32, bs=8, t=4, lens=[5, 17, 32]),
    # dead trailing blocks: lens far below the table width
    "dead_trailing": dict(b=2, h=4, kh=1, hd=64, bs=4, t=6, lens=[3, 9]),
    # pad entries pointing at arbitrary (live, foreign) blocks
    "pad_entries_anywhere": dict(b=3, h=4, kh=2, hd=32, bs=8, t=4,
                                 lens=[1, 12, 25], dead_entries=True),
    # the gateway's pad lanes: ctx 1 against the null block
    "pad_lanes": dict(b=2, h=16, kh=2, hd=128, bs=16, t=2, lens=[1, 1],
                      dead_entries=False),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_paged_attention_matches_jax(case):
    q, kb, vb, tables, lens = _attention_case(7, **ATTENTION_CASES[case])
    got = paged_attention(*(torch.from_numpy(a) for a in (q, kb, vb, tables, lens)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    jargs = tuple(jnp.asarray(a) for a in (q, kb, vb, tables, lens))
    oracle = np.asarray(jax_ref.paged_attention(*jargs))
    kernel = np.asarray(jax_paged_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), kernel, atol=1e-5, rtol=1e-5)


def _write_case(seed, dtype_np):
    r = np.random.default_rng(seed)
    p, bs, kh, hd, b = 9, 4, 2, 64, 5
    kb = r.standard_normal((p + 1, bs, kh, hd)).astype(dtype_np)
    vb = r.standard_normal((p + 1, bs, kh, hd)).astype(dtype_np)
    nk = r.standard_normal((b, kh, hd)).astype(np.float32)
    nv = r.standard_normal((b, kh, hd)).astype(np.float32)
    ids = np.concatenate([r.permutation(p)[:3], [p, p]]).astype(np.int32)  # 2 pad lanes
    offs = r.integers(0, bs, b).astype(np.int32)
    return kb, vb, nk, nv, ids, offs


def test_paged_decode_write_matches_jax():
    kb, vb, nk, nv, ids, offs = _write_case(3, np.float32)
    tk, tv = paged_decode_write(*(torch.from_numpy(a.copy())
                                  for a in (kb, vb, nk, nv, ids, offs)))
    jargs = tuple(jnp.asarray(a) for a in (kb, vb, nk, nv, ids, offs))
    null = kb.shape[0] - 1
    for jk, jv in (jax_ref.paged_decode_write(*jargs),
                   jax_paged_decode_write(*jargs, interpret=True)):
        np.testing.assert_array_equal(tk.numpy()[:null], np.asarray(jk)[:null])
        np.testing.assert_array_equal(tv.numpy()[:null], np.asarray(jv)[:null])


def test_paged_decode_write_casts_into_pool_dtype():
    """f32 tokens into a bf16 pool round to nearest even, like JAX's astype."""
    kb, vb, nk, nv, ids, offs = _write_case(4, np.float32)
    tk, tv = paged_decode_write(
        torch.from_numpy(kb).bfloat16(), torch.from_numpy(vb).bfloat16(),
        *(torch.from_numpy(a) for a in (nk, nv, ids, offs)))
    jk, _ = jax_ref.paged_decode_write(
        jnp.asarray(kb, jnp.bfloat16), jnp.asarray(vb, jnp.bfloat16),
        *(jnp.asarray(a) for a in (nk, nv, ids, offs)))
    null = kb.shape[0] - 1
    np.testing.assert_array_equal(tk.float().numpy()[:null],
                                  np.asarray(jk, np.float32)[:null])


SCALES = {"per_column": lambda r, c: (1, c), "per_row": lambda r, c: (r, 1),
          "scalar": lambda r, c: (1, 1)}
# two live intervals plus an inert lo == hi slot
INTERVALS = [(0.0, 0.004), (0.5, 0.5), (0.012, 0.02)]


@pytest.mark.parametrize("scale_kind", sorted(SCALES))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_masked_dequant_matches_jax(scale_kind, out_dtype):
    """512 x 384 >= 256 x 256, so the JAX dispatcher runs its Pallas kernel."""
    r = np.random.default_rng(11)
    rows, cols = 512, 384
    codes = r.integers(-127, 128, (rows, cols)).astype(np.int8)
    scale = (r.random(SCALES[scale_kind](rows, cols)) * 2e-4 + 1e-5).astype(np.float32)
    got = ops.masked_dequant(torch.from_numpy(codes), torch.from_numpy(scale),
                             INTERVALS, out_dtype=getattr(torch, out_dtype))
    jdt = getattr(jnp, out_dtype)
    want = jax_ops.masked_dequant(jnp.asarray(codes), jnp.asarray(scale),
                                  INTERVALS, out_dtype=jdt, interpret=True)
    lo, hi = jax_ops.pack_intervals(INTERVALS)
    oracle = jax_ref.masked_dequant(jnp.asarray(codes), jnp.asarray(scale),
                                    lo, hi, jdt)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(got, np.asarray(oracle, np.float32))
    assert (got == 0).mean() > 0.05         # the intervals do mask weights


# stacked (U, R, C) scale forms: name -> scale shape
STACKED_SCALES = {"per_column": lambda u, r, c: (u, 1, c),
                  "per_column_shared": lambda u, r, c: (1, 1, c),
                  "per_row": lambda u, r, c: (u, r, 1),
                  "scalar": lambda u, r, c: (1, 1, 1)}


def _bits(a: np.ndarray) -> np.ndarray:
    """The bit patterns of a bf16 / f32 array (+0.0 and -0.0 differ)."""
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _stacked_case(seed, u, r, c, scale_kind):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (u, r, c)).astype(np.int8)
    scale = (rng.random(STACKED_SCALES[scale_kind](u, r, c)) * 2e-4
             + 1e-5).astype(np.float32)
    return codes, scale


def _edge_intervals(codes, scale):
    """INTERVALS plus one whose bounds are two of the weights themselves
    (|codes * scale| in f32, outside INTERVALS where any two are): a
    weight equal to lo is masked, one equal to hi is not."""
    mag = np.unique(np.abs(codes.astype(np.float32) * scale))
    mag = mag[mag > 0]
    free = mag[~np.any([(mag >= a) & (mag < b) for a, b in INTERVALS], axis=0)]
    # a small scalar scale can leave every weight inside INTERVALS
    mag = free if len(free) >= 2 else mag
    lo, hi = mag[len(mag) // 4], mag[3 * len(mag) // 4]
    return INTERVALS + [(float(lo), float(hi))], lo, hi


@pytest.mark.parametrize("scale_kind", sorted(STACKED_SCALES))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_masked_dequant_stacked_matches_jax(scale_kind, out_dtype):
    """One call on a stacked (U, R, C) leaf (the plain version on the CPU)
    against the JAX oracle applied slice by slice and stacked, as the JAX
    package's ``materialize_licensed_view`` builds a leaf; bit for bit."""
    codes, scale = _stacked_case(21, 3, 40, 72, scale_kind)
    intervals, edge_lo, edge_hi = _edge_intervals(codes, scale)
    lo, hi = ops.pack_intervals(intervals)
    got = masked_dequant(torch.from_numpy(codes), torch.from_numpy(scale), lo, hi,
                         out_dtype=getattr(torch, out_dtype))
    assert got.shape == codes.shape and ops.LAUNCHES["masked_dequant"] == 0
    jlo, jhi = jax_ops.pack_intervals(intervals)
    full = np.broadcast_to(scale, (codes.shape[0], *scale.shape[1:]))
    want = np.stack([np.asarray(jax_ref.masked_dequant(
        jnp.asarray(codes[i]), jnp.asarray(full[i]), jlo, jhi, getattr(jnp, out_dtype)))
        for i in range(codes.shape[0])])
    np.testing.assert_array_equal(
        got.view(torch.int16 if out_dtype == "bfloat16" else torch.int32).numpy(), _bits(want))
    assert (want == 0).mean() > 0.05
    mag = np.abs(codes.astype(np.float32) * scale)
    assert (got.float().numpy()[mag == edge_lo] == 0).all()
    assert (got.float().numpy()[mag == edge_hi] != 0).all()


def test_pack_intervals_matches_jax():
    lo, hi = ops.pack_intervals(INTERVALS)
    jlo, jhi = jax_ops.pack_intervals(INTERVALS)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert ops.MAX_INTERVALS == jax_ops.MAX_INTERVALS


def _delta_case(seed, n, n_delta, n_pad):
    """A flat buffer, unique in-range indices (shuffled), ``n_pad``
    padding indices equal to N, and values.  Index 0 stays out of the
    delta: the JAX oracle aims its padding lanes at index 0 (rewriting
    the old value), and a real entry there would race them."""
    r = np.random.default_rng(seed)
    buf = r.standard_normal(n).astype(np.float32)
    idx = np.concatenate([1 + r.choice(n - 1, n_delta, replace=False),
                          np.full(n_pad, n)]).astype(np.int64)
    val = r.standard_normal(n_delta + n_pad).astype(np.float32)
    return buf, idx, val


DELTA_CASES = {
    # 2 tiles of the JAX kernel's 4096 block: the Pallas kernel runs
    "pallas_tiles": dict(n=8192, n_delta=40, n_pad=3),
    # ragged N (the JAX dispatcher pads to a block multiple)
    "ragged": dict(n=10_000, n_delta=25, n_pad=2),
    # under one block: the JAX dispatcher takes its oracle
    "small": dict(n=300, n_delta=17, n_pad=1),
    "empty": dict(n=8192, n_delta=0, n_pad=0),
}


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("buf_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_apply_matches_jax(case, buf_dtype, donate):
    """``ops.delta_apply`` on the CPU vs the JAX dispatcher (Pallas in
    interpret mode where it tiles) and the JAX oracle: padding indices
    dropped, f32 values into a bf16 buffer rounded like ``astype``, the
    donated buffer written in place and the copy leaving it untouched."""
    buf, idx, val = _delta_case(13, **DELTA_CASES[case])
    jdt, tdt = getattr(jnp, buf_dtype), getattr(torch, buf_dtype)
    tbuf = torch.from_numpy(buf).to(tdt)
    before = tbuf.clone()
    got = ops.delta_apply(tbuf, torch.from_numpy(idx), torch.from_numpy(val),
                          donate=donate)
    assert got.dtype == tdt and got.shape == tbuf.shape
    assert (got.data_ptr() == tbuf.data_ptr()) == donate
    if not donate:
        assert torch.equal(tbuf, before)
    jbuf = jnp.asarray(buf, jdt)
    want = jax_ops.delta_apply(jbuf, jnp.asarray(idx), jnp.asarray(val),
                               interpret=True)
    oracle = jax_ref.delta_apply(jbuf, jnp.asarray(idx), jnp.asarray(val))
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(got, np.asarray(oracle, np.float32))


def test_delta_apply_drops_negative_indices():
    buf = torch.zeros(8)
    out = ops.delta_apply(buf, torch.tensor([-1, 3, 8, -9]),
                          torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert out.tolist() == [0, 0, 0, 2.0, 0, 0, 0, 0]
    assert ops.LAUNCHES["delta_apply"] == 0          # CPU: the plain version


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain(cuda, dtype):
    # f32: 1e-5 (summation order); bf16 inputs: both versions compute in
    # f32 from the same bf16 values, so the same bound holds
    q, kb, vb, tables, lens = _attention_case(
        5, b=8, h=16, kh=2, hd=128, bs=16, t=6, lens=[1, 17, 40, 96, 3, 64, 80, 33],
        dead_entries=True)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, lens)]
    for i in range(3):
        args[i] = args[i].to(getattr(torch, dtype))
    got = paged_attention(*args)
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_paged_decode_write_kernel_matches_plain(cuda):
    kb, vb, nk, nv, ids, offs = _write_case(6, np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (kb, vb, nk, nv, ids, offs)]
    k1, v1 = paged_decode_write(args[0].clone(), args[1].clone(), *args[2:])
    k2, v2 = ref.paged_decode_write(args[0].clone(), args[1].clone(), *args[2:])
    torch.cuda.synchronize()
    null = kb.shape[0] - 1
    assert torch.equal(k1[:null], k2[:null]) and torch.equal(v1[:null], v2[:null])


def _scale_for(codes, scale_kind, rng):
    """A scale of ``scale_kind`` for 2-D or stacked codes."""
    u, r, c = codes.shape if codes.ndim == 3 else (1, *codes.shape)
    shape = STACKED_SCALES[scale_kind](u, r, c)
    shape = shape if codes.ndim == 3 else shape[1:]
    return (torch.rand(shape, generator=rng) * 2e-4 + 1e-5).to(codes.device)


@pytest.mark.gpu
@pytest.mark.parametrize("scale_kind", sorted(STACKED_SCALES))
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cols", [11008, 2048, 1003])
def test_masked_dequant_kernel_matches_plain(cuda, scale_kind, stacked, cols):
    """Bit for bit against the plain version, f32 and bf16 out: the MLP's
    widths and a ragged one (the one-element-per-thread kernel), 2-D and
    stacked, every scale form; then codes whose base is off a 16-byte
    boundary (a view one byte into a buffer)."""
    rng = torch.Generator().manual_seed(12)
    shape = (3, 70, cols) if stacked else (300, cols)
    n = int(np.prod(shape))
    flat = torch.randint(-127, 128, (n + 1,), generator=rng, dtype=torch.int8).to(cuda)
    aligned = flat[:n].view(shape)
    offset = flat[1:].view(shape)
    assert offset.data_ptr() % 16 != 0
    scale = _scale_for(aligned, scale_kind, rng)
    intervals, _, _ = _edge_intervals(aligned.cpu().numpy(), scale.cpu().numpy())
    lo, hi = ops.pack_intervals(intervals, cuda)
    for codes in (aligned, offset):
        for dtype, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
            before = ops.LAUNCHES["masked_dequant"]
            got = masked_dequant(codes, scale, lo, hi, out_dtype=dtype)
            want = ref.masked_dequant(codes, scale, lo, hi, dtype)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["masked_dequant"] == before + 1
            assert got.dtype == dtype and got.shape == codes.shape
            assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.gpu
def test_masked_dequant_kernel_in_cuda_graph(cuda):
    """Captured once, replayed after the codes and the intervals changed
    in place: the kernel reads both on the card at replay."""
    rng = torch.Generator().manual_seed(13)
    codes = torch.randint(-127, 128, (4, 64, 2048), generator=rng, dtype=torch.int8).to(cuda)
    scale = _scale_for(codes, "per_column", rng)
    lo, hi = ops.pack_intervals(INTERVALS, cuda)
    masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)   # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = masked_dequant(codes, scale, lo, hi, out_dtype=torch.bfloat16)
    codes.copy_(torch.randint(-127, 128, codes.shape, generator=rng,
                              dtype=torch.int8).to(cuda))
    new_lo, new_hi = ops.pack_intervals([(0.0, 0.02)], cuda)
    lo.copy_(new_lo)
    hi.copy_(new_hi)
    graph.replay()
    want = ref.masked_dequant(codes, scale, lo, hi, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_masked_dequant_kernel_rejects(cuda):
    codes = torch.zeros(2, 8, 32, dtype=torch.int8, device=cuda)
    scale = torch.ones(2, 1, 32, device=cuda)
    lo, hi = ops.pack_intervals(INTERVALS, cuda)
    with pytest.raises(TypeError, match="int8"):
        masked_dequant(codes.to(torch.int16), scale, lo, hi)
    for bad in (torch.ones(2, 1, 31, device=cuda), torch.ones(3, 1, 32, device=cuda),
                torch.ones(2, 8, 2, device=cuda), torch.ones(1, 32, device=cuda)):
        with pytest.raises(ValueError, match="scale"):
            masked_dequant(codes, bad, lo, hi)
    with pytest.raises(ValueError, match="lo on cpu"):
        masked_dequant(codes, scale, lo.cpu(), hi)
    with pytest.raises(TypeError, match="out_dtype"):
        masked_dequant(codes, scale, lo, hi, out_dtype=torch.float16)


@pytest.mark.gpu
@pytest.mark.parametrize("idx_dtype", ["int32", "int64"])
@pytest.mark.parametrize("val_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("buf_dtype", ["float32", "bfloat16"])
def test_delta_apply_kernel_matches_plain(cuda, buf_dtype, val_dtype, idx_dtype):
    """Bit-exact against the plain version, both forms, padding included;
    the out-of-place form leaves its input untouched."""
    buf, idx, val = _delta_case(14, n=1 << 20, n_delta=50_000, n_pad=7)
    b = torch.from_numpy(buf).to(cuda, getattr(torch, buf_dtype))
    i = torch.from_numpy(idx).to(cuda, getattr(torch, idx_dtype))
    v = torch.from_numpy(val).to(cuda, getattr(torch, val_dtype))
    want = ref.delta_apply(b, i, v)
    before = b.clone()
    got = delta_apply(b, i, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(b, before)
    got = delta_apply(b, i, v, donate=True)
    torch.cuda.synchronize()
    assert got.data_ptr() == b.data_ptr() and torch.equal(b, want)
