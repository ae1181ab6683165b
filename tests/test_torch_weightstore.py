"""The port's WeightStore against the JAX package's, on shared store files.

Both packages write and read one schema: a store file written by either
opens in the other and reconstructs the same bytes, and ``delta_since``
answers every query (full pull, an increment across a skipped version,
a pull after a rollback) with identical ``LayerDelta``s — names, shapes,
dtype strings, indices, value bytes, page bytes and compression flags —
and identical checksums.  The layers mix bf16 and f32 and a small
``row_limit`` puts some in rows mode and some in chunk mode (with a
short last page); the port holds bf16 on the host as raw bits, the JAX
package as ``ml_dtypes.bfloat16``, so every comparison is on bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.transport import packet_checksum as jax_packet_checksum
from repro.core.weightstore import WeightStore as JaxWeightStore

from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.core.transport import packet_checksum
from repro_torch.core.weightstore import (WeightStore, bf16_to_f32, f32_to_bf16,
                                          to_host)
from repro_torch.models.model import params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STORE_KW = dict(row_limit=64, chunk_elems=16)
SHAPES = {  # name -> (shape, dtype); > 64 elements is chunk mode
    "a/w": ((10, 10), "bfloat16"),     # chunk, short last page
    "a/norm_scale": ((12,), "bfloat16"),
    "b/w": ((8, 16), "float32"),       # chunk
    "b/bias": ((3, 7), "float32"),     # rows, 2-D
    "c/w": ((4, 8), "bfloat16"),       # rows, 2-D
}


def _jax_params(seed, base=None):
    """Flat numpy params in the JAX package's types (bf16 via ml_dtypes);
    ``base`` given: a copy with a few entries changed, one zeroed."""
    r = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in SHAPES.items():
        if base is None:
            a = r.standard_normal(shape).astype(np.float32)
            a.reshape(-1)[::5] = 0.0                     # pruned entries
        else:
            a = np.asarray(base[name], np.float32).copy()
            flat = a.reshape(-1)
            hit = r.choice(flat.size, 3, replace=False)
            flat[hit] = r.standard_normal(3)
            flat[hit[0]] = 0.0                           # became zero
        out[name] = a.astype(jnp.bfloat16) if dt == "bfloat16" else a
    return out


def _nested(flat):
    return unflatten(dict(flat))


def _bits(x):
    """Comparable host bytes of a leaf from either package."""
    if isinstance(x, torch.Tensor):
        return to_host(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_params(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = _bits(fa[k]), _bits(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _assert_same_packet(p, q):
    assert (p.model, p.from_version, p.to_version) == (q.model, q.from_version,
                                                         q.to_version)
    assert len(p.deltas) == len(q.deltas)
    for d, e in zip(p.deltas, q.deltas):
        assert (d.layer, tuple(d.shape), d.dtype, d.chunk_elems) == \
               (e.layer, tuple(e.shape), e.dtype, e.chunk_elems)
        assert d.indices.dtype == e.indices.dtype == np.int64
        np.testing.assert_array_equal(d.indices, e.indices)
        if e.chunks is None:
            assert d.chunks is None
            assert _bits(d.values).tobytes() == _bits(e.values).tobytes(), d.layer
            assert d.values.itemsize == e.values.itemsize
        else:
            assert d.chunks == e.chunks and d.chunk_flags() == e.chunk_flags()
        assert d.nbytes == e.nbytes
    assert packet_checksum(p) == jax_packet_checksum(q)


def test_bf16_conversions_match_ml_dtypes():
    """Round to nearest even at ties and near overflow, NaN stays NaN."""
    r = np.random.default_rng(0)
    x = np.concatenate([r.standard_normal(10_000).astype(np.float32) * 3,
                        np.array([0.0, -0.0, 1.00390625, 1.01171875, 3.4e38,
                                  -3.4e38, np.inf, -np.inf, 1e-40], np.float32)])
    want = x.astype(jnp.bfloat16)
    assert f32_to_bf16(x).tobytes() == want.view(np.uint16).tobytes()
    np.testing.assert_array_equal(bf16_to_f32(want.view(np.uint16)),
                                  want.astype(np.float32))
    assert np.isnan(bf16_to_f32(f32_to_bf16(np.array([np.nan], np.float32))))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_file_opens_in_the_other_package(tmp_path, writer):
    """A store written by one package checks out bit-identically in the
    other, both as a flat dict and into a template."""
    path = str(tmp_path / "lm.db")
    flat = _jax_params(1)
    if writer == "jax":
        s = JaxWeightStore(path, **STORE_KW)
        s.commit("m", _nested(flat))
    else:
        s = WeightStore(path, **STORE_KW)
        s.commit("m", params_from_jax(flat, device="cpu"))
    s.close()
    expect = params_from_jax(flat, device="cpu")
    port = WeightStore(path, **STORE_KW)
    jax_store = JaxWeightStore(path, **STORE_KW)
    storage = dict(port.conn.execute("SELECT name, storage FROM layer"))
    assert set(storage.values()) == {"rows", "chunks"}
    _assert_same_params(_nested(port.checkout("m")), expect)
    _assert_same_params(_nested(jax_flatten_params(jax_store.checkout("m"))), expect)
    _assert_same_params(port.checkout("m", template=expect), expect)
    assert port.storage_bytes("m") == jax_store.storage_bytes("m")


def test_delta_since_identical_across_packages():
    """None -> v1, v1 -> v3 across a skipped v2, and the full snapshot a
    client on v3 gets after a rollback to v1: identical packets."""
    v1 = _jax_params(1)
    v2 = _jax_params(2, base=v1)
    v3 = _jax_params(3, base=v2)
    stores = (JaxWeightStore(":memory:", **STORE_KW), WeightStore(":memory:", **STORE_KW))
    for s in stores:
        for flat in (v1, v2, v3):
            tree = _nested(flat)
            if isinstance(s, WeightStore):
                tree = params_from_jax(flat, device="cpu")
            s.commit("m", tree)
    jax_store, port = stores
    assert [h["id"] for h in port.history("m")] == [1, 2, 3]
    for client, target in ((None, 1), (1, 3), (2, 3), (3, 3)):
        _assert_same_packet(port.delta_since("m", client, target),
                            jax_store.delta_since("m", client, target))
    full = port.delta_since("m", None, 1)
    assert {d.values.dtype for d in full.deltas} == {np.dtype(np.uint16),
                                                    np.dtype(np.float32)}
    for s in stores:
        s.rollback("m", 1)
    assert port.production_version("m") == jax_store.production_version("m") == 1
    _assert_same_packet(port.delta_since("m", 3), jax_store.delta_since("m", 3))
    for version in (1, 2, 3):
        _assert_same_params(_nested(port.checkout("m", version)),
                            _nested(jax_flatten_params(jax_store.checkout("m", version))))


def test_tiers_and_legacy_guard(tmp_path):
    """Tier rows round-trip between the packages, and a format-1 store
    holding non-f32 chunk pages is refused by the port too."""
    path = str(tmp_path / "tiers.db")
    s = JaxWeightStore(path, **STORE_KW)
    s.commit("m", _nested(_jax_params(1)))
    s.register_tier("m", 1, "free", 0.5, {"*": [(0.0, 0.01)], "b/": [(0.2, 0.3)]})
    s.close()
    port = WeightStore(path, **STORE_KW)
    assert port.get_tier("m", "free") == (0.5, {"*": [(0.0, 0.01)], "b/": [(0.2, 0.3)]})
    assert port.list_tiers("m") == [("free", 0.5)]
    port.conn.execute("PRAGMA user_version=0")     # masquerade as format 1
    port.conn.commit()
    port.close()
    with pytest.raises(RuntimeError, match="format 1"):
        WeightStore(path)
