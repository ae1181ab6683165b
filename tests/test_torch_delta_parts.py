"""The staged sync's one apply per step (``delta_apply_parts``) on the CPU.

A STAGE step's parts become segments (``core.delta.part_segments``: a
rows part, or one run a chunk page) and one ``delta_apply_parts`` applies
them.  Here, with inputs from a numpy seed, the plain version over the
segment list and the plain unpacker of the packed step buffer (the layout
the CUDA kernel reads: segment table, tile map, payload) are held bit for
bit against

* the per-part sequence: ``ref.delta_apply`` in place for each rows part
  and a slice copy for each page, in order;
* the JAX stager's own apply (``repro.serving.updates.UpdateStager.
  _apply_part``: ``repro.kernels.ops.delta_apply(donate=True)`` for rows,
  the donated page ``dynamic_update_slice``) and the port's stager
  (``_apply_part`` + ``_apply_segments``), step by step;

on bf16 and f32 layers, f32 values rounded half to even into bf16, bf16
values, padding indices (== size) and negative ones (against the port's
sequence only: JAX's plain scatter wraps a negative index), short last
pages, compressed and raw pages, several layers in one step, a layer
whose parts span two steps and an empty step.  No tolerance: the apply
moves bits.  The ``gpu`` case holds the kernel to the plain version.
"""
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.weightstore import LayerDelta as JaxLayerDelta
from repro.serving.updates import UpdateStager as JaxStager

from repro_torch.core.delta import part_segments
from repro_torch.core.weightstore import LayerDelta
from repro_torch.kernels import ops, ref
from repro_torch.kernels.delta_apply import (Rows, Run, StepRing, delta_apply_parts,
                                             plan_step, write_step)
from repro_torch.serving.updates import UpdateStager

# layer -> (shape, dtype, storage, chunk_elems): two chunk-mode layers
# with short last pages (bf16 pages of 1,024 elements in one tile; f32
# pages of 8,192 in two, the last 1,003 elements, not a multiple of 16
# bytes), and three rows layers (f32 values into f32, two of the JAX
# kernel's 4,096-element tiles, so the JAX stager runs its Pallas kernel in
# interpret mode; f32 values into bf16 with ties to round; bf16 values
# into bf16)
LAYERS = {
    "a/w": ((5, 1000), "bfloat16", "chunks", 1024),
    "a/b": ((8192,), "float32", "rows", 0),
    "n/s": ((2, 1500), "bfloat16", "rows", 0),
    "n/t": ((700,), "bfloat16", "rows", 0),
    "f/w": ((17387,), "float32", "chunks", 8192),
}
# the steps: (layer, which pages) for chunk layers, (layer, rows) for rows;
# a/w's pages span steps 0 and 1, step 3 carries nothing
STEPS = [[("a/w", [0, 1, 2])],
         [("a/w", [3, 4]), ("a/b", None)],
         [("n/s", None), ("n/t", None), ("f/w", [0, 1, 2])],
         []]


def _bits(x: np.ndarray) -> np.ndarray:
    """bf16 bits (np.uint16) of float32 values, rounded to nearest even."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)).view(np.uint16)


def _make(seed: int, negatives: bool):
    """v1 of every layer (host arrays, bf16 as bits) and the parts of each
    step as (port LayerDelta, JAX LayerDelta) pairs."""
    rng = np.random.default_rng(seed)
    v1, steps = {}, []
    for name, (shape, dtype, _, _) in LAYERS.items():
        x = rng.standard_normal(int(np.prod(shape))).astype(np.float32)
        v1[name] = _bits(x) if dtype == "bfloat16" else x
    for step in STEPS:
        parts = []
        for name, pages in step:
            shape, dtype, storage, ce = LAYERS[name]
            size = int(np.prod(shape))
            if storage == "chunks":
                parts.append(_pages(rng, name, shape, dtype, ce, size, pages))
                continue
            n = {"a/b": 900, "n/s": 2500, "n/t": 300}[name]
            # index 0 stays out: JAX's plain scatter sends padding to index 0
            # (with its old value), a tie beside a real update there
            idx = np.sort(1 + rng.choice(size - 1, n, replace=False)).astype(np.int64)
            pad = [size, size]
            if negatives:
                pad += [-1, -size]
            idx = np.concatenate([idx, np.array(pad, np.int64)])
            val = rng.standard_normal(idx.size).astype(np.float32)
            if name == "n/s":        # exact ties between two bf16 values
                u = val.view(np.uint32)
                u[::3] = (u[::3] & 0xFFFF0000) | 0x8000
            if name == "n/t":        # bf16 values, as a full snapshot ships them
                parts.append(_pair(name, shape, dtype, idx, values=_bits(val)))
            else:
                parts.append(_pair(name, shape, dtype, idx, values=val))
        steps.append(parts)
    return v1, steps


def _pages(rng, name, shape, dtype, ce, size, pages):
    chunks, flags = [], []
    for ci in pages:
        n = min(ce, size - ci * ce)
        x = rng.standard_normal(n).astype(np.float32)
        raw = (_bits(x) if dtype == "bfloat16" else x).tobytes()
        comp = ci % 2 == 1
        chunks.append(zlib.compress(raw, 1) if comp else raw)
        flags.append(comp)
    return _pair(name, shape, dtype, np.array(pages, np.int64), chunks=chunks,
                 chunk_elems=ce, chunk_compressed=flags)


def _pair(name, shape, dtype, idx, values=None, **chunks):
    port = LayerDelta(layer=name, shape=shape, dtype=dtype, indices=idx, values=values,
                      **chunks)
    jvals = values
    if values is not None and values.dtype == np.uint16:
        jvals = values.view(ml_dtypes.bfloat16)
    return port, JaxLayerDelta(layer=name, shape=shape, dtype=dtype, indices=idx,
                               values=jvals, **chunks)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.copy().view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.reshape(-1)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _port_flat(v1):
    return {name: _tensor(a).reshape(LAYERS[name][0]) for name, a in v1.items()}


def _per_part(v1, steps):
    """The per-part sequence: each rows part through ref.delta_apply in
    place, each page a slice copy, in order (each layer cloned once)."""
    flat = _port_flat(v1)
    for parts in steps:
        for d, _ in parts:
            buf = flat[d.layer].reshape(-1)
            if d.chunks is None:
                ref.delta_apply(buf, _tensor(d.indices), _tensor(d.values), donate=True)
            else:
                for ci, page in d.iter_pages():
                    buf[ci * d.chunk_elems: ci * d.chunk_elems + page.size].copy_(_tensor(page))
    return {k: _host(v) for k, v in flat.items()}


def _segmented(v1, steps, packed):
    """Each step's parts as segments through the plain list version, or
    packed into one buffer and applied by the plain unpacker."""
    flat = _port_flat(v1)
    for parts in steps:
        segs = [s for d, _ in parts for s in part_segments(flat[d.layer].reshape(-1), d)]
        if not packed:
            ref.delta_apply_parts(segs)
            continue
        plan = plan_step(segs)
        buf = np.zeros(plan.nbytes, np.uint8)
        write_step(plan, buf)
        ref.delta_apply_packed(torch.from_numpy(buf), plan.map_off, plan.payload_off,
                               plan.n_tiles, [s.dst for s in segs])
    return {k: _host(v) for k, v in flat.items()}


def _jax_stager(v1, steps):
    """The JAX stager's own apply of the same parts."""
    st = JaxStager.__new__(JaxStager)
    st._flat = {name: (a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a.copy())
                .reshape(LAYERS[name][0]) for name, a in v1.items()}
    st._pending_layer = st._pending_buf = None
    for parts in steps:
        for _, jd in parts:
            st._apply_part(jd)
    if st._pending_layer is not None:
        st._finalize_layer()
    return {k: np.asarray(v).reshape(-1).view(np.uint16)
            if LAYERS[k][1] == "bfloat16" else np.asarray(v).reshape(-1)
            for k, v in st._flat.items()}


def _port_stager(v1, steps):
    """The port's stager: ``_apply_part`` for each part of a step, then
    the step's one ``_apply_segments`` (the plain route on the CPU)."""
    st = UpdateStager.__new__(UpdateStager)
    st._flat = _port_flat(v1)
    st._cloned, st._segments, st._ring = set(), [], None
    originals = dict(st._flat)
    for parts in steps:
        for d, _ in parts:
            st._apply_part(d)
        st._apply_segments()
    for name, t in originals.items():        # copy-on-stage: v1 untouched
        np.testing.assert_array_equal(_host(t), v1[name])
    return {k: _host(v) for k, v in st._flat.items()}


def _same(got, want):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("route", ["plain", "packed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_parts_match_the_per_part_sequence(seed, route):
    """Negative indices included: the port drops them on every route."""
    v1, steps = _make(seed, negatives=True)
    _same(_segmented(v1, steps, packed=route == "packed"), _per_part(v1, steps))


@pytest.mark.parametrize("route", ["plain", "packed", "stager"])
@pytest.mark.parametrize("seed", [2, 3])
def test_parts_match_the_jax_stager(seed, route):
    v1, steps = _make(seed, negatives=False)
    want = _jax_stager(v1, steps)
    got = (_port_stager(v1, steps) if route == "stager"
           else _segmented(v1, steps, packed=route == "packed"))
    _same(got, want)
    _same(_per_part(v1, steps), want)
    assert ops.LAUNCHES["delta_apply_inplace"] == 0       # the CPU launches nothing


def test_packed_layout():
    """One step's plan: a 64-byte entry a segment (empty ones dropped),
    every tile mapped to its segment in order, sections 16-byte aligned,
    a run's tiles of 16 KiB and a rows segment's of 1,024 entries."""
    dst = torch.zeros(40_000)
    segs = [Run(dst, 3, np.ones(5000, np.float32)),        # 20,000 B: 2 tiles
            Rows(dst, np.zeros(0, np.int64), np.zeros(0, np.float32)),
            Rows(dst, np.arange(9000, 11_049, dtype=np.int32),
                 np.ones(2049, np.float32)),               # 3 tiles
            Run(dst, 20_000, np.ones(1, np.float32))]      # 1 tile
    plan = plan_step(segs)
    assert plan.table.shape == (3, 8) and plan.n_tiles == 6
    assert plan.tile_seg.tolist() == [0, 0, 1, 1, 1, 2]
    assert plan.table[:, 6].tolist() == [0, 2, 5]          # first tiles
    assert plan.map_off == 3 * 64 and plan.payload_off % 16 == 0
    assert all(off % 16 == 0 for off, _ in plan.pieces)
    assert plan.table[1, 7] == 0 | (4 << 32)                # rows, int32 indices
    assert plan.table[0, 7] == 1 | ((4 << 8) << 32)         # a run of 4-byte elements
    buf = np.zeros(plan.nbytes, np.uint8)
    write_step(plan, buf)
    ref.delta_apply_packed(torch.from_numpy(buf), plan.map_off, plan.payload_off,
                           plan.n_tiles, [dst])
    want = torch.zeros(40_000)
    want[3:5003] = 1
    want[9000:11_049] = 1
    want[20_000] = 1
    assert torch.equal(dst, want)


def test_empty_step_and_checks():
    """An empty step packs to nothing and launches nothing; the wrappers
    refuse what the kernel does not take."""
    plan = plan_step([])
    assert plan.n_tiles == 0 and plan.table.shape == (0, 8)
    delta_apply_parts([])
    with pytest.raises(TypeError, match="destination dtype"):
        plan_step([Run(torch.zeros(8, dtype=torch.bfloat16), 0, np.ones(2, np.float32))])
    with pytest.raises(ValueError, match="outside"):
        plan_step([Run(torch.zeros(8), 7, np.ones(2, np.float32))])
    with pytest.raises(ValueError, match="flat"):
        plan_step([Run(torch.zeros(2, 4), 0, np.ones(2, np.float32))])
    with pytest.raises(TypeError, match="indices"):
        plan_step([Rows(torch.zeros(8), np.zeros(2, np.float32), np.ones(2, np.float32))])
    with pytest.raises(ValueError, match="no kernel"):
        delta_apply_parts([Run(torch.zeros(8, device="meta"), 0, np.ones(2, np.float32))])
    with pytest.raises(ValueError, match="CUDA"):
        StepRing("cpu", 1 << 10)


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: delta_apply_parts is a CUDA kernel")
    from repro_torch.kernels.build import load_extension

    load_extension()
    return torch.device("cuda")


@pytest.mark.gpu
def test_delta_apply_parts_kernel_matches_plain(cuda):
    """Three steps through one two-slot ring (the first slot reused after
    its event): rows of every dtype pairing and index width with padding
    and negatives, aligned and odd-offset runs, short pages; bit for bit
    the plain version's, one launch a step."""
    rng = np.random.default_rng(7)
    f32 = torch.from_numpy(rng.standard_normal(300_001).astype(np.float32)).to(cuda)
    b16 = torch.from_numpy(rng.standard_normal(300_001).astype(np.float32)).to(
        cuda).bfloat16()

    def rows(dst, lo, hi, n, itype, bf16_values):
        idx = (lo + rng.choice(hi - lo, n, replace=False)).astype(itype)
        idx = np.concatenate([idx, np.array([dst.numel(), -1, -7], itype)])
        val = rng.standard_normal(idx.size).astype(np.float32)
        return Rows(dst, idx, _bits(val) if bf16_values else val)

    def run(dst, offset, n):
        x = rng.standard_normal(n).astype(np.float32)
        return Run(dst, offset, _bits(x) if dst.dtype == torch.bfloat16 else x)

    # one step's segments write disjoint elements (the store's contract)
    steps = [[run(b16, 0, 65536), run(b16, 65536, 65536),
              rows(f32, 0, 300_001, 5000, np.int64, False)],
             [rows(b16, 0, 100_000, 3000, np.int64, False),
              rows(b16, 100_000, 200_000, 2000, np.int32, True),
              run(f32, 131072, 4097), run(b16, 200_001, 999)],      # odd offset
             [run(f32, 7, 33), rows(f32, 1000, 300_001, 1500, np.int32, True),
              run(b16, 299_000, 1001)]]
    ring = StepRing(cuda, 1 << 20, slots=2)
    want_f32, want_b16 = f32.clone(), b16.clone()
    swap = {f32.data_ptr(): want_f32, b16.data_ptr(): want_b16}
    n0 = ops.LAUNCHES["delta_apply_inplace"]
    for i, segs in enumerate(steps):
        delta_apply_parts(segs, ring=ring)
        assert ops.LAUNCHES["delta_apply_inplace"] == n0 + i + 1
        ref.delta_apply_parts([s._replace(dst=swap[s.dst.data_ptr()]) for s in segs])
    torch.cuda.synchronize()
    assert torch.equal(f32, want_f32) and torch.equal(b16, want_b16)
    ring.close()
