"""The port's ``flash_attention`` against the JAX package's, on shared
numpy inputs.

On the CPU the wrapper takes its plain version (``ref.flash_attention``);
it is held against the JAX oracle (``repro.kernels.ref.flash_attention``)
and against the Pallas kernel run in interpret mode, at the JAX tests'
tolerance (rtol = atol = 2e-3; the two f32 softmaxes differ only in
summation order).  Ragged Sq / Sk, which the port takes and the Pallas
kernel does not (it asserts block multiples), are held against the oracle
only.  The cases marked ``gpu`` hold the CUDA kernels (both designs)
against the plain version on the card, in f32 and bf16, at 2e-3; they
skip elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from test_torch_kernels import cuda  # noqa: F401  (the card fixture)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-3, atol=2e-3)


def _qkv(seed, bh, sq, sk, hd, bkh):
    r = np.random.default_rng(seed)
    return (r.standard_normal((bh, sq, hd)).astype(np.float32),
            r.standard_normal((bkh, sk, hd)).astype(np.float32),
            r.standard_normal((bkh, sk, hd)).astype(np.float32))


# shapes and masks of tests/test_flash_attention.py; (bq, bk) are the
# Pallas kernel's blocks in interpret mode
CASES = {
    "causal": dict(bh=4, sq=256, sk=256, hd=64, bkh=4, mask=dict(causal=True),
                   blocks=(128, 128)),
    "gqa_groups4": dict(bh=8, sq=256, sk=256, hd=64, bkh=2,
                        mask=dict(causal=True, groups=4), blocks=(128, 128)),
    "window128": dict(bh=2, sq=512, sk=512, hd=64, bkh=2,
                      mask=dict(causal=True, window=128), blocks=(128, 128)),
    "offset896": dict(bh=2, sq=128, sk=1024, hd=64, bkh=2,
                      mask=dict(causal=True, q_offset=896), blocks=(128, 256)),
    "noncausal": dict(bh=2, sq=256, sk=256, hd=64, bkh=2, mask=dict(causal=False),
                      blocks=(128, 128)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case):
    c = CASES[case]
    q, k, v = _qkv(sorted(CASES).index(case), c["bh"], c["sq"], c["sk"], c["hd"], c["bkh"])
    ops.reset_launches()
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **c["mask"])
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert ops.LAUNCHES["flash_attention"] == 0           # CPU: the plain version
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = jax_ref.flash_attention(jq, jk, jv, **c["mask"])
    bq, bk = c["blocks"]
    kernel = jax_flash_attention(jq, jk, jv, block_q=bq, block_k=bk, interpret=True,
                                 **c["mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)


@pytest.mark.parametrize("mask", [dict(causal=True, q_offset=200, groups=2),
                                  dict(causal=True, window=37, q_offset=250, groups=2),
                                  dict(causal=False, groups=2)],
                         ids=["causal_offset", "window", "noncausal"])
def test_flash_attention_ragged_lengths(mask):
    """Sq = 100 and Sk = 300 are no block multiples: the port takes them
    (the Pallas kernel asserts), held against the JAX oracle."""
    q, k, v = _qkv(21, 4, 100, 300, 64, 2)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **mask)
    want = jax_ref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("mask", [dict(causal=True, q_offset=-64),
                                  dict(causal=True, window=128, q_offset=1000)],
                         ids=["negative_offset", "window_past_the_keys"])
def test_flash_attention_rows_without_keys_are_zero(mask):
    """Rows whose every key is masked give 0, not NaN (the TPU kernel's
    alpha guard and max(l, 1e-20)); the Pallas kernel agrees."""
    q, k, v = _qkv(22, 2, 128, 512, 64, 2)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **mask).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kernel = np.asarray(jax_flash_attention(jq, jk, jv, block_q=128, block_k=128,
                                            interpret=True, **mask))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref.flash_attention(jq, jk, jv, **mask)),
                               **TOL)
    q_pos = mask["q_offset"] + np.arange(128)
    if "window" in mask:
        dead = q_pos - mask["window"] >= 511              # no key > pos - window
    else:
        dead = q_pos < 0                                  # no key <= pos
    assert dead.any() and np.isfinite(got).all()
    assert (got[:, dead] == 0).all() and (got[:, ~dead] != 0).any(axis=-1).all()


def test_flash_attention_design_by_dtype_and_head_dim():
    """bf16 at hd 64 / 128 takes the wgmma kernel; f32 and hd 32 the
    mma.sync one (the choice is a function of dtype and hd alone)."""
    from repro_torch.kernels.flash_attention import design

    assert design(torch.bfloat16, 128) == design(torch.bfloat16, 64) == "wgmma"
    assert design(torch.bfloat16, 32) == "mma_sync"
    assert design(torch.float32, 128) == "mma_sync"


def test_flash_attention_bf16_inputs_give_f32():
    """bf16 in, f32 out: the plain version upcasts the same bf16 values
    the JAX oracle does."""
    q, k, v = _qkv(23, 4, 128, 128, 64, 2)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, groups=2)
    want = jax_ref.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                     for t in (tq, tk, tv)), groups=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------- on the card only
GPU_CASES = {
    # ragged Sq / Sk off the 64-row / 64-key tiles, GQA
    "ragged_causal": dict(bh=8, sq=100, sk=300, hd=64, bkh=2,
                          mask=dict(causal=True, q_offset=200, groups=4)),
    "window": dict(bh=4, sq=333, sk=333, hd=128, bkh=2,
                   mask=dict(causal=True, window=50, groups=2)),
    "noncausal_hd32": dict(bh=2, sq=70, sk=129, hd=32, bkh=1,
                           mask=dict(causal=False, groups=2)),
    "rows_without_keys": dict(bh=2, sq=128, sk=256, hd=64, bkh=2,
                              mask=dict(causal=True, q_offset=-40)),
    # full width of qwen2.5-3b: 16 q heads over 2 kv heads, hd 128, the
    # last 512 rows of a 4096-token prompt
    "qwen_full_width": dict(bh=16, sq=512, sk=4096, hd=128, bkh=2,
                            mask=dict(causal=True, q_offset=3584, groups=8)),
    # off the wgmma design's 128-row q tiles and 128-key k tiles (bf16,
    # hd 128 and 64): one row, 129 rows, 200 keys, a window with a
    # negative offset (leading rows without keys)
    "tiles_sq1": dict(bh=4, sq=1, sk=200, hd=128, bkh=2,
                      mask=dict(causal=True, q_offset=199, groups=2)),
    "tiles_sq129_sk200": dict(bh=4, sq=129, sk=200, hd=128, bkh=2,
                              mask=dict(causal=True, q_offset=71, groups=2)),
    "tiles_window_negative_offset": dict(bh=4, sq=300, sk=260, hd=128, bkh=2,
                                         mask=dict(causal=True, window=64, q_offset=-30,
                                                   groups=2)),
    "tiles_noncausal_hd64": dict(bh=4, sq=129, sk=200, hd=64, bkh=1,
                                 mask=dict(causal=False, groups=4)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):  # noqa: F811
    """2e-3 abs/rel: bf16 products are exact and p is carried as two bf16
    terms; f32 inputs are split likewise (csrc/flash_attention.cu).  bf16
    at hd 64 / 128 runs the wgmma kernel (csrc/flash_attention_sm90.cu),
    the rest the mma.sync one."""
    c = GPU_CASES[case]
    args = [torch.from_numpy(a).to(cuda, getattr(torch, dtype))
            for a in _qkv(24, c["bh"], c["sq"], c["sk"], c["hd"], c["bkh"])]
    ops.reset_launches()
    got = flash_attention(*args, **c["mask"])
    want = ref.flash_attention(*args, **c["mask"])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
