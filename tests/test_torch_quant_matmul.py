"""The port's ``quant_matmul`` against the JAX package's, on shared numpy
inputs.

On the CPU ``ops.quant_matmul`` takes the plain version
(``ref.quant_matmul``: dequantize in f32, f32 product, one cast); it is
held against the JAX oracle and against the JAX dispatcher running the
Pallas kernel in interpret mode, at out f32 and at the tolerances of
``tests/test_kernels.py`` for the same cases (2e-2, 1e-2, 1e-3).  The
Pallas kernel adds each K block's partial into the output in the output
dtype, so it is compared only at out f32, where the two agree; bf16 x
with the default (bf16) out is held against the oracle, within one bf16
rounding (1e-2).  The cases marked ``gpu`` hold the CUDA kernel against
the plain version on the card; they skip elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.kernels import ops, ref
from test_torch_kernels import cuda  # noqa: F401  (the card fixture)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _case(seed, lead, k, n, scale_kind="random"):
    r = np.random.default_rng(seed)
    x = r.standard_normal((*lead, k)).astype(np.float32)
    codes = r.integers(-127, 128, (k, n)).astype(np.int8)
    if scale_kind == "const":
        scale = np.full(n, 0.02, np.float32)
    else:
        scale = (np.abs(r.standard_normal(n)) * 0.02 + 1e-4).astype(np.float32)
    return x, codes, scale


# (leading dims, K, N, tolerance) of the JAX tests; every product is at
# least 128^3, so the JAX dispatcher runs its Pallas kernel
CASES = {
    "decode_m8": dict(lead=(8,), k=1024, n=256, tol=2e-2),
    "unaligned": dict(lead=(130,), k=700, n=200, tol=1e-2),
    "leading_dims": dict(lead=(4, 64), k=512, n=128, tol=1e-3, scale_kind="const"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quant_matmul_matches_jax(case):
    c = CASES[case]
    x, codes, scale = _case(sorted(CASES).index(case), c["lead"], c["k"], c["n"],
                            c.get("scale_kind", "random"))
    ops.reset_launches()
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                           torch.from_numpy(scale))
    assert got.shape == (*c["lead"], c["n"]) and got.dtype == torch.float32
    assert ops.LAUNCHES["quant_matmul"] == 0              # CPU: the plain version
    jx, jc, js = jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale)
    kernel = jax_ops.quant_matmul(jx, jc, js, out_dtype=jnp.float32, interpret=True)
    oracle = jax_ref.quant_matmul(jx.reshape(-1, c["k"]), jc, js,
                                  jnp.float32).reshape(*c["lead"], c["n"])
    tol = dict(rtol=c["tol"], atol=c["tol"])
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **tol)


def test_quant_matmul_bf16_default_out_dtype():
    """bf16 x: out_dtype defaults to bf16, rounded once from the f32 sum
    (the oracle's contract); at out f32 the Pallas kernel agrees too."""
    x, codes, scale = _case(7, (8,), 1024, 256)
    tx = torch.from_numpy(x).bfloat16()
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scale)
    got = ops.quant_matmul(tx, tc, ts)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 256)
    jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    jc, js = jnp.asarray(codes), jnp.asarray(scale)
    oracle = jax_ref.quant_matmul(jx, jc, js, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32),
                               rtol=1e-2, atol=1e-2)
    got32 = ops.quant_matmul(tx, tc, ts, out_dtype=torch.float32)
    kernel = jax_ops.quant_matmul(jx, jc, js, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got32.numpy(), np.asarray(kernel), rtol=2e-2, atol=2e-2)
    assert ops.LAUNCHES["quant_matmul"] == 0


# ------------------------------------------------------- on the card only
GPU_CASES = {
    # ragged M, K and N; N % 4 != 0 takes the kernel's scalar code loads,
    # K % 8 != 0 its scalar x loads
    "ragged": dict(m=130, k=700, n=203),
    "decode_m8": dict(m=8, k=1000, n=256),
    "m1": dict(m=1, k=64, n=40),
    # the MLP of qwen2.5-3b: an 8-lane decode step's up and down projections
    "qwen_up_m8": dict(m=8, k=2048, n=11008),
    "qwen_down_m8": dict(m=8, k=11008, n=2048),
    "qwen_up_m512": dict(m=512, k=2048, n=11008),
    # across the bf16 designs' boundaries (split-K up to M = SMALL_M = 32,
    # wgmma above): K off the 64-row slices, N off 8 and 16 (scalar code
    # loads), K % 8 != 0 (scalar x loads), the prefill's M
    "splitk_m1_ragged": dict(m=1, k=1000, n=203),
    "splitk_m32_n1000": dict(m=32, k=4100, n=1000),
    "wgmma_m33_k700": dict(m=33, k=700, n=256),
    "qwen_down_m4096": dict(m=4096, k=11008, n=2048),
}


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_quant_matmul_kernel_matches_plain(cuda, case, x_dtype, out_dtype):  # noqa: F811
    """Relative to the largest |output|.  Every product is exact (bf16 x
    as is, f32 x as three bf16 terms), but the tensor cores add each k16
    step into the f32 accumulator with truncation, losing up to about one
    f32 ulp (2^-23) of the partial sum per step: f32 out within
    ceil(K / 16) * terms * 2^-23 (terms = 3 for f32 x); bf16 out within
    that plus 2^-7, one bf16 rounding of two f32 sums that may straddle a
    rounding boundary."""
    assert not torch.backends.cuda.matmul.allow_tf32   # the plain product is full f32
    c = GPU_CASES[case]
    x, codes, scale = _case(31, (c["m"],), c["k"], c["n"])
    tx = torch.from_numpy(x).to(cuda, getattr(torch, x_dtype))
    tc, ts = torch.from_numpy(codes).to(cuda), torch.from_numpy(scale).to(cuda)
    odt = getattr(torch, out_dtype)
    ops.reset_launches()
    got = ops.quant_matmul(tx, tc, ts, out_dtype=odt)
    want = ref.quant_matmul(tx, tc, ts, odt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quant_matmul"] == 1
    assert got.dtype == odt and got.shape == (c["m"], c["n"])
    top = want.float().abs().max().item()
    tol = -(-c["k"] // 16) * (3 if x_dtype == "float32" else 1) * 2.0 ** -23
    if out_dtype == "bfloat16":
        tol += 2.0 ** -7
    assert (got.float() - want.float()).abs().max().item() <= tol * top


def _qmm_tol(k, terms=1, bf16_out=True):
    """The gpu cases' bound relative to the largest |output| (see above)."""
    return -(-k // 16) * terms * 2.0 ** -23 + (2.0 ** -7 if bf16_out else 0.0)


@pytest.mark.parametrize("m", [1, 8, 32, 33])
def test_quant_matmul_design_by_dtype_and_m(m):
    """bf16 x up to SMALL_M rows takes the split-K kernel, more rows the
    wgmma kernel; f32 x the mma.sync kernel, whatever M."""
    from repro_torch.kernels.quant_matmul import SMALL_M, design

    assert SMALL_M == 32
    assert design(torch.bfloat16, m) == ("splitk" if m <= 32 else "wgmma")
    assert design(torch.float32, m) == "mma_sync"


@pytest.mark.parametrize("m,k,n", [(8, 11008, 2048), (8, 2048, 11008), (1, 1000, 203),
                                   (32, 4100, 512)],
                         ids=["qwen_down_m8", "qwen_up_m8", "ragged_m1", "m32_k4100"])
def test_quant_matmul_splitk_arithmetic(m, k, n):
    """The split-K design's arithmetic in plain PyTorch: f32 partials over
    the planned K slices (an H100's 132 SMs), summed in slice order, scaled
    and cast once, agree with ``ref.quant_matmul`` within the kernel's
    bound; the plan covers K exactly with non-empty 64-row-multiple slices
    and fills the card with at least 4 blocks per SM where K allows."""
    from repro_torch.kernels.quant_matmul import splitk_plan

    slices, slice_k = splitk_plan(k, n, 132)
    assert slice_k % 64 == 0 and (slices - 1) * slice_k < k <= slices * slice_k
    blocks = -(-n // 128) * slices
    assert blocks >= 4 * 132 or slice_k == 64
    x, codes, scale = _case(41, (m,), k, n)
    tx = torch.from_numpy(x).bfloat16()
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scale)
    total = torch.zeros(m, n, dtype=torch.float32)
    for s in range(slices):
        ks = slice(s * slice_k, min(k, (s + 1) * slice_k))
        total += tx[:, ks].float() @ tc[ks].float()
    got = (total * ts[None, :]).bfloat16()
    want = ref.quant_matmul(tx, tc, ts, torch.bfloat16)
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= _qmm_tol(k) * top
