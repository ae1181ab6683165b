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
  room for rounding differences.  The null block's content is garbage by
  contract and is never compared.

The cases marked ``gpu`` hold each CUDA / Triton kernel against its plain
version on the card; they skip on a machine without one.
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


@pytest.mark.gpu
@pytest.mark.parametrize("scale_kind", sorted(SCALES))
def test_masked_dequant_kernel_matches_plain(cuda, scale_kind):
    pytest.importorskip("triton", reason="the masked_dequant kernel is Triton")
    r = np.random.default_rng(12)
    rows, cols = 300, 77                      # ragged edges in both dims
    codes = torch.from_numpy(r.integers(-127, 128, (rows, cols)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy((r.random(SCALES[scale_kind](rows, cols)) * 2e-4
                              + 1e-5).astype(np.float32)).to(cuda)
    lo, hi = ops.pack_intervals(INTERVALS, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = masked_dequant(codes, scale, lo, hi, out_dtype=dtype)
        want = ref.masked_dequant(codes, scale, lo, hi, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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
