"""The split-context design of ``paged_attention``: its plan and its
arithmetic on the CPU, and the kernels against their plain versions on the
card.

``split_plan`` is pure Python and is checked at the shapes chip_smoke runs
(phase 2's ragged contexts, the serving stream, an 8 x 4096-token decode)
and at its edges, and its shared-memory cap (``split_smem``, the CUDA
source's layout) at GQA groups up to 64.  ``_split_emulation`` repeats the kernel's arithmetic in
plain PyTorch: per split of table columns, scores of the valid keys, one max
and one sum per head, p . v without rescaling; then the splits that hold a
live key combined in a fixed order, as the combine kernel does (contiguous
ranges folded with an online max, then the ranges in order).  It is held
at 1e-5 in f32 (the tolerance of ``test_torch_kernels.py``: only the order
of the sums differs) against ``ref.paged_attention``, the JAX oracle and
the Pallas kernel in interpret mode.  The cases marked ``gpu`` hold both
CUDA kernels against their plain versions on the card at the same
tolerances (1e-5; the write exact), check that the extension rejects what
the kernels do not take, and that a check inside a ``.cu`` source raises
rather than ending the process.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.paged_attention import paged_attention as jax_paged_attention

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import (MAX_GROUPS, MAX_SMEM, SPLIT_BLOCKS_PER_SM,
                                                 SPLIT_MAX_KEYS, SPLIT_MIN_KEYS,
                                                 paged_attention, paged_decode_write,
                                                 split_plan, split_smem)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

H100_SMS = 132
NEG_INF = -1e30
COMBINE_WARPS = 8     # the combine kernel's warps (csrc/paged_attention.cu)

# (n_tab, block_size, batch, kv_heads) -> the plan on an H100's 132 SMs
PLANS = {
    "phase2": ((38, 16, 8, 2), (19, 2)),        # contexts 1-600
    "serving": ((6, 16, 8, 2), (3, 2)),         # contexts 9-96
    "long": ((256, 16, 8, 2), (37, 7)),         # 8 x 4096 tokens
    "one_column": ((1, 16, 8, 2), (1, 1)),
    "fewer_columns_than_sms": ((100, 16, 1, 1), (50, 2)),
    "one_lane": ((256, 16, 1, 2), (128, 2)),
    "pages_past_max_keys": ((8, 1024, 2, 2), (8, 1)),
    "tiny_pages": ((64, 4, 8, 2), (8, 8)),
    # deepseek-moe-16b's decode: MHA, 16 kv heads a lane (GQA group 1)
    "mha_serving": ((6, 16, 8, 16), (3, 2)),
    "mha_long": ((256, 16, 8, 16), (8, 32)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_split_plan(case):
    (n_tab, bs, b, kh), want = PLANS[case]
    splits, cols = split_plan(n_tab, bs, b, kh, H100_SMS)
    assert (splits, cols) == want
    # every column in exactly one split, none empty by shape
    assert 1 <= cols <= n_tab and (splits - 1) * cols < n_tab <= splits * cols
    assert cols * bs <= SPLIT_MAX_KEYS or cols == 1
    # the card filled, or every split already at its least size
    least = min(n_tab, max(1, -(-SPLIT_MIN_KEYS // bs)))
    assert b * kh * splits >= SPLIT_BLOCKS_PER_SM * H100_SMS or cols == least


def test_split_plan_reads_shapes_only():
    """The plan is a function of shapes and the SM count alone."""
    assert split_plan(0, 16, 8, 2, H100_SMS) == (1, 1)
    assert split_plan(38, 16, 8, 2, 1) == (2, 32)
    assert split_plan(256, 16, 8, 2, 66) == (18, 15)


# (groups, head_dim, K/V bytes, block_size, n_tab, batch, kv_heads): granite-34b's
# decode (48 q heads on 1 kv head) at the serving stream's and at 4096-token
# contexts, nemotron-4-15b's (48 over 8), and the largest layouts the kernel
# takes (64 q heads a kv head, head_dim 256, f32), where the scores of
# SPLIT_MAX_KEYS keys would overflow shared memory
SMEM_CASES = {
    "granite_serving": (48, 128, 2, 16, 6, 8, 1),
    "granite_4096": (48, 128, 2, 16, 256, 8, 1),
    "nemotron_4096": (6, 128, 2, 16, 256, 8, 8),
    "groups_64_hd256_f32": (64, 256, 4, 16, 64, 64, 8),
    "groups_48_hd256_f32": (48, 256, 4, 16, 64, 64, 8),
    "groups_64_hd256_bf16": (64, 256, 2, 16, 64, 64, 8),
}


@pytest.mark.parametrize("case", sorted(SMEM_CASES))
def test_split_plan_fits_shared_memory(case):
    """The plan keeps a split block's shared memory (the CUDA source's
    layout, ``split_smem``) within 227 KB at every group the kernel takes;
    it cuts columns only where the layout would not fit."""
    g, hd, elt, bs, n_tab, b, kh = SMEM_CASES[case]
    splits, cols = split_plan(n_tab, bs, b, kh, H100_SMS, groups=g, head_dim=hd, elt=elt)
    assert split_smem(g, hd, elt, bs, cols) <= MAX_SMEM
    assert (splits - 1) * cols < n_tab <= splits * cols
    free_cols = split_plan(n_tab, bs, b, kh, H100_SMS)[1]     # the plan without the layout
    if split_smem(g, hd, elt, bs, free_cols) <= MAX_SMEM:
        assert cols == free_cols
    else:
        assert cols < free_cols and split_smem(g, hd, elt, bs, cols + 1) > MAX_SMEM
    assert g <= MAX_GROUPS


def test_split_smem_layout():
    """The byte layout of csrc/paged_attention.cu's ``split_smem`` at
    granite's decode shape: 8 mbarriers, 32 table entries, 2 x 48
    floats, q (48, 128) f32, scores (48, 512) f32, then 5 stages of 16
    padded bf16 rows of 272 bytes."""
    want = 64 + 128 + 384 + 48 * 128 * 4 + 48 * 512 * 4 + 5 * 16 * 272
    assert split_smem(48, 128, 2, 16, 32) == want == 145216


def _split_emulation(q, kb, vb, tables, lens, cols):
    """The kernel's arithmetic in plain f32 PyTorch (see the module note)."""
    b, h, hd = q.shape
    _, bs, kh, _ = kb.shape
    groups, n_tab = h // kh, tables.shape[1]
    splits = -(-n_tab // cols) if n_tab else 1
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(b, h, hd)
    for lane in range(b):
        ctx = int(lens[lane])
        n_live = min(n_tab, -(-max(ctx, 0) // bs))
        parts = []
        for s in range(splits):
            c0 = s * cols
            n = min(cols, n_live - c0)
            if n <= 0:                       # past the lane's context: m, l only
                parts.append((torch.full((kh, groups), NEG_INF), torch.zeros(kh, groups),
                              None))
                continue
            pages = tables[lane, c0:c0 + n].long()
            n_keys = min(n * bs, ctx - c0 * bs)
            k = kb[pages].reshape(n * bs, kh, hd)[:n_keys].float()
            v = vb[pages].reshape(n * bs, kh, hd)[:n_keys].float()
            qg = q[lane].float().reshape(kh, groups, hd)
            sc = torch.einsum("kgd,nkd->kgn", qg, k) * scale
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", p, v)))
        live = [pt for pt in parts if pt[2] is not None]   # the first splits
        # the combine: COMBINE_WARPS contiguous ranges of the live splits,
        # each folded in order with an online max, then the ranges in order
        per = -(-len(live) // COMBINE_WARPS)
        folded = []
        for w in range(COMBINE_WARPS):
            m, l_w, a_w = torch.full((kh, groups), NEG_INF), torch.zeros(kh, groups), 0.0
            for ms, ls, acc_s in live[w * per:(w + 1) * per]:
                mn = torch.maximum(m, ms)
                a, c = torch.exp(m - mn), torch.exp(ms - mn)
                l_w = l_w * a + ls * c
                a_w = a_w * a[..., None] + acc_s * c[..., None]
                m = mn
            if live[w * per:(w + 1) * per]:
                folded.append((m, l_w, a_w))
        if not folded:
            continue                         # no valid key: the row is 0
        mx = torch.stack([m for m, _, _ in folded]).max(0).values
        l_tot = torch.zeros(kh, groups)
        acc = torch.zeros(kh, groups, hd)
        for m, l_w, a_w in folded:
            w = torch.exp(m - mx)
            l_tot = l_tot + l_w * w
            acc = acc + a_w * w[..., None]
        out[lane] = (acc / l_tot[..., None]).reshape(h, hd)
    return out


def _case(seed, b, h, kh, hd, bs, t, lens, dead_entries=None):
    """As test_torch_kernels._attention_case: disjoint tables, ragged lens;
    dead table entries rewritten to arbitrary blocks (True) or the block 0
    (False) when given."""
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


EMULATION_CASES = {
    # test_torch_kernels.ATTENTION_CASES
    "gqa_ragged": dict(b=3, h=8, kh=2, hd=32, bs=8, t=4, lens=[5, 17, 32]),
    "dead_trailing": dict(b=2, h=4, kh=1, hd=64, bs=4, t=6, lens=[3, 9]),
    "pad_entries_anywhere": dict(b=3, h=4, kh=2, hd=32, bs=8, t=4,
                                 lens=[1, 12, 25], dead_entries=True),
    "pad_lanes": dict(b=2, h=16, kh=2, hd=128, bs=16, t=2, lens=[1, 1],
                      dead_entries=False),
    # several splits, splits past the context, a pad lane against block 0
    "splits_empty_and_pad": dict(b=4, h=8, kh=2, hd=64, bs=4, t=12,
                                 lens=[1, 7, 48, 21], dead_entries=False),
    # GQA groups of 48: granite-34b's MQA (48 over 1) and nemotron-4-15b's
    # head count over 8 kv heads at a small head_dim
    "groups_48_mqa": dict(b=2, h=48, kh=1, hd=32, bs=8, t=5, lens=[9, 37],
                          dead_entries=True),
    "heads_48_over_8": dict(b=3, h=48, kh=8, hd=32, bs=4, t=6, lens=[5, 22, 1],
                            dead_entries=False),
    # GQA group 1: deepseek-moe-16b's MHA decode, 16 q heads on 16 kv heads
    # at hd 128
    "mha_group_1": dict(b=3, h=16, kh=16, hd=128, bs=16, t=4, lens=[9, 40, 64],
                        dead_entries=True),
}


@pytest.mark.parametrize("cols", ["plan", 1, 3])
@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_split_emulation_matches_oracles(case, cols):
    c = EMULATION_CASES[case]
    q, kb, vb, tables, lens = _case(11, **c)
    if cols == "plan":
        cols = split_plan(c["t"], c["bs"], c["b"], c["kh"], H100_SMS)[1]
    got = _split_emulation(*(torch.from_numpy(a) for a in (q, kb, vb, tables, lens)), cols)
    want = ref.paged_attention(*(torch.from_numpy(a) for a in (q, kb, vb, tables, lens)))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    jargs = tuple(jnp.asarray(a) for a in (q, kb, vb, tables, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref.paged_attention(*jargs)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_paged_attention(*jargs, interpret=True)),
                               atol=1e-5, rtol=1e-5)


def test_split_emulation_row_without_keys_is_zero():
    """A lane with context 0 has no valid key in any split: 0, as the
    plain version gives."""
    q, kb, vb, tables, lens = _case(12, b=2, h=4, kh=2, hd=32, bs=4, t=5, lens=[0, 13])
    args = [torch.from_numpy(a) for a in (q, kb, vb, tables, lens)]
    got = _split_emulation(*args, 2)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, ref.paged_attention(*args), atol=1e-5, rtol=1e-5)


def test_wrappers_take_the_plain_version_on_cpu():
    q, kb, vb, tables, lens = (torch.from_numpy(a) for a in _case(
        13, b=2, h=4, kh=2, hd=32, bs=4, t=3, lens=[5, 9]))
    ops.reset_launches()
    torch.testing.assert_close(paged_attention(q, kb, vb, tables, lens),
                               ref.paged_attention(q, kb, vb, tables, lens))
    paged_decode_write(kb, vb, q[:, :2], q[:, :2], tables[:, 0], lens % 4)
    assert ops.LAUNCHES["paged_attention"] == ops.LAUNCHES["paged_decode_write"] == 0


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (b, h, kh, bs, t, lens): one split by plan, many splits, a 4096-token lane
CARD_CASES = {
    "one_split": (8, 16, 2, 16, 2, [1, 17, 32, 9, 3, 30, 25, 2]),
    "many_splits": (8, 16, 2, 16, 38, [1, 17, 100, 255, 311, 480, 555, 600]),
    "lane_4096": (2, 16, 2, 16, 256, [4096, 1]),
    "groups_32": (2, 64, 2, 16, 20, [300, 77]),
    "groups_48": (8, 48, 1, 16, 24, [9, 23, 40, 57, 64, 75, 88, 380]),
    "mha_group_1": (8, 16, 16, 16, 6, [9, 23, 40, 57, 64, 75, 88, 96]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_paged_attention_split_kernel_matches_plain(cuda, case, dtype, hd):
    b, h, kh, bs, t, lens = CARD_CASES[case]
    q, kb, vb, tables, ctx = _case(21, b=b, h=h, kh=kh, hd=hd, bs=bs, t=t, lens=lens,
                                   dead_entries=True)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    for i in range(3):
        args[i] = args[i].to(getattr(torch, dtype))
    splits, _ = split_plan(t, bs, b, kh, torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)
    assert (splits == 1) == (case == "one_split")
    got = paged_attention(*args)
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_head_dims(cuda, dtype, hd):
    """The other two head dims, with a lane of context 0 (its row is 0)."""
    q, kb, vb, tables, ctx = _case(22, b=3, h=8, kh=1, hd=hd, bs=8, t=9,
                                   lens=[0, 70, 9], dead_entries=True)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    for i in range(3):
        args[i] = args[i].to(getattr(torch, dtype))
    got = paged_attention(*args)
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_largest_layouts(cuda, dtype):
    """64 q heads on one kv head at head_dim 256: the plan cuts columns
    to fit shared memory, and the kernel matches the plain version."""
    lens = [1024, 1, 333, 700]
    q, kb, vb, tables, ctx = _case(28, b=4, h=64, kh=1, hd=256, bs=16, t=64, lens=lens,
                                   dead_entries=True)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    for i in range(3):
        args[i] = args[i].to(getattr(torch, dtype))
    got = paged_attention(*args)
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_paged_attention_groups_48_in_a_cuda_graph(cuda):
    """Granite-34b's decode (48 q heads over 1 kv head, hd 128, bf16) in a
    CUDA graph: a replay with new lengths gives the plain version's answer."""
    q, kb, vb, tables, ctx = _case(29, b=8, h=48, kh=1, hd=128, bs=16, t=256,
                                   lens=[4096, 1, 17, 2000, 96, 4095, 64, 3000])
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    for i in range(3):
        args[i] = args[i].bfloat16()
    paged_attention(*args)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention(*args)
    args[4].copy_(torch.tensor([1, 4096, 700, 33, 2048, 9, 4000, 128], dtype=torch.int32))
    graph.replay()
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_paged_attention_kernel_in_a_cuda_graph(cuda):
    """The wrapper neither synchronises nor reads the lengths on the host:
    captured once, a replay with new lengths gives the new answer."""
    q, kb, vb, tables, ctx = _case(23, b=8, h=16, kh=2, hd=128, bs=16, t=38,
                                   lens=[1, 17, 100, 255, 311, 480, 555, 600])
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    for i in range(3):
        args[i] = args[i].bfloat16()
    paged_attention(*args)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention(*args)
    args[4].copy_(torch.tensor([600, 1, 33, 16, 200, 599, 64, 2], dtype=torch.int32))
    graph.replay()
    want = ref.paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tok_dtype", ["float32", "bfloat16"])
def test_paged_decode_write_kernel_dtypes(cuda, tok_dtype, pool_dtype):
    """Every pair of token and pool dtypes, exact against the plain
    version; the null block (last) excluded."""
    r = np.random.default_rng(24)
    p, bs, kh, hd, b = 17, 16, 2, 128, 8
    kb = torch.from_numpy(r.standard_normal((p, bs, kh, hd)).astype(np.float32))
    vb = torch.from_numpy(r.standard_normal((p, bs, kh, hd)).astype(np.float32))
    nk = torch.from_numpy(r.standard_normal((b, kh, hd)).astype(np.float32))
    nv = torch.from_numpy(r.standard_normal((b, kh, hd)).astype(np.float32))
    ids = torch.from_numpy(np.concatenate([r.permutation(p - 1)[: b - 2], [p - 1, p - 1]])
                           .astype(np.int32)).to(cuda)
    offs = torch.from_numpy(r.integers(0, bs, b).astype(np.int32)).to(cuda)
    pools = [x.to(cuda, getattr(torch, pool_dtype)) for x in (kb, vb)]
    toks = [x.to(cuda, getattr(torch, tok_dtype)) for x in (nk, nv)]
    k1, v1 = paged_decode_write(pools[0].clone(), pools[1].clone(), *toks, ids, offs)
    k2, v2 = ref.paged_decode_write(pools[0].clone(), pools[1].clone(), *toks, ids, offs)
    torch.cuda.synchronize()
    assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])


def _attention_args(cuda):
    q, kb, vb, tables, ctx = _case(25, b=2, h=4, kh=2, hd=64, bs=8, t=3, lens=[5, 20])
    return [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]


BAD_ATTENTION = {
    "q dtype": (lambda a: a.__setitem__(0, a[0].double()), TypeError, "share one dtype"),
    "k/v dtypes": (lambda a: a.__setitem__(1, a[1].bfloat16()), TypeError, "share one dtype"),
    "table dtype": (lambda a: a.__setitem__(3, a[3].long()), TypeError, "int32"),
    "q rank": (lambda a: a.__setitem__(0, a[0][0]), ValueError, "must be"),
    "head_dim": (lambda a: [a.__setitem__(i, a[i][..., :48].contiguous()) for i in range(3)],
                 ValueError, "head_dim 48"),
    "groups": (lambda a: a.__setitem__(0, a[0][:, :3].contiguous()), ValueError, "groups"),
    "lens shape": (lambda a: a.__setitem__(4, a[4][:1]), ValueError, "for batch"),
    "v shape": (lambda a: a.__setitem__(2, a[2][:-1].contiguous()), ValueError, "do not match"),
    "non-contiguous k": (lambda a: a.__setitem__(1, a[1].transpose(0, 1)), ValueError,
                         "k_blocks must be contiguous"),
    "tables on the cpu": (lambda a: a.__setitem__(3, a[3].cpu()), ValueError,
                          "block_tables on cpu"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bad", sorted(BAD_ATTENTION))
def test_paged_attention_rejects_from_the_extension(cuda, bad):
    args = _attention_args(cuda)
    edit, exc, msg = BAD_ATTENTION[bad]
    edit(args)
    with pytest.raises(exc, match=msg):
        paged_attention(*args)


def _write_args(cuda):
    r = np.random.default_rng(26)
    kb = torch.from_numpy(r.standard_normal((5, 4, 2, 64)).astype(np.float32)).to(cuda)
    nk = torch.from_numpy(r.standard_normal((3, 2, 64)).astype(np.float32)).to(cuda)
    ids = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda)
    offs = torch.tensor([1, 3, 0], dtype=torch.int32, device=cuda)
    return [kb, kb.clone(), nk, nk.clone(), ids, offs]


BAD_WRITE = {
    "token dtype": (lambda a: a.__setitem__(2, a[2].double()), TypeError, "new_k dtype"),
    "k/v dtypes": (lambda a: a.__setitem__(1, a[1].bfloat16()), TypeError, "dtypes differ"),
    "token shape": (lambda a: a.__setitem__(2, a[2][:, :1].contiguous()), ValueError,
                    "mismatch"),
    "ids dtype": (lambda a: a.__setitem__(4, a[4].long()), ValueError, r"\(B,\) int32"),
    "non-contiguous pool": (lambda a: a.__setitem__(0, a[0].transpose(1, 2)), ValueError,
                            "k_blocks must be contiguous"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("bad", sorted(BAD_WRITE))
def test_paged_decode_write_rejects_from_the_extension(cuda, bad):
    args = _write_args(cuda)
    edit, exc, msg = BAD_WRITE[bad]
    edit(args)
    with pytest.raises(exc, match=msg):
        paged_decode_write(*args)


@pytest.mark.gpu
def test_paged_attention_shared_memory_check_raises(cuda):
    """Pages too large for a split block's shared memory trip the check in
    csrc/paged_attention.cu; its message carries the sizes."""
    q, kb, vb, tables, ctx = _case(27, b=1, h=32, kh=1, hd=256, bs=2048, t=1, lens=[5])
    args = [torch.from_numpy(a).to(cuda) for a in (q, kb, vb, tables, ctx)]
    with pytest.raises(ValueError, match="block_size 2048 with 1 columns per split needs"):
        paged_attention(*args)
    torch.cuda.synchronize()


def _splitk_m40(ext, dev):
    x = torch.zeros(40, 64, dtype=torch.bfloat16, device=dev)
    codes = torch.zeros(64, 128, dtype=torch.int8, device=dev)
    scale = torch.ones(128, device=dev)
    ws = torch.empty(1, 40, 128, device=dev)
    return ext.quant_matmul_splitk(x, codes, scale, ws, 64, False)


# each check in a .cu source whose message streams an integer, reached past
# its Python wrapper: (call, message)
CU_CHECKS = {
    "flash_attention f32 head_dim": (
        lambda ext, dev: ext.flash_attention(*[torch.zeros(1, 16, 48, device=dev)] * 3,
                                             True, 0, 0, 1), "head_dim 48 not in"),
    "flash_attention bf16 head_dim": (
        lambda ext, dev: ext.flash_attention(
            *[torch.zeros(1, 16, 64, device=dev, dtype=torch.bfloat16)] * 3, True, 0, 0, 1),
        "bf16 head_dim 64 belongs"),
    "flash_attention_sm90 head_dim": (
        lambda ext, dev: ext.flash_attention_sm90(
            *[torch.zeros(1, 16, 32, device=dev, dtype=torch.bfloat16)] * 3, True, 0, 0, 1),
        "head_dim 32 not in"),
    "quant_matmul split-K rows": (_splitk_m40, "M=40 above 32"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("check", sorted(CU_CHECKS))
def test_cuda_source_check_with_an_integer_raises(cuda, check):
    """The module links the process's shared libstdc++ (build.LINK_FLAGS),
    so a failing check that formats an integer raises RuntimeError rather
    than ending the process."""
    from repro_torch.kernels.build import load_extension

    call, msg = CU_CHECKS[check]
    with pytest.raises(RuntimeError, match=msg):
        call(load_extension(), cuda)
