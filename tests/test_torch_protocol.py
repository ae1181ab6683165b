"""The port's update protocol against the JAX package's, on the CPU.

One store content, written by each package into its own store: license
masking of rows and pages (f32 and bf16), the chunk-granular cursor
(parts at several byte budgets, including a ``tell``/``seek`` resume),
the whole-packet client pull, and the chaos transport's fault schedule
must all come out identical — bytes, checksums, counters and the
weights the client ends up with.  The host-side delta helpers
(``encode_delta``, ``delta_to_dense``, ``shard_delta``) are held against
``repro.core.delta`` on the same packets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jax_delta
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.protocol import EdgeClient as JaxEdgeClient
from repro.core.protocol import LicenseServer as JaxLicenseServer
from repro.core.protocol import _mask_packet as jax_mask_packet
from repro.core.transport import ChaosTransport as JaxChaosTransport
from repro.core.transport import packet_checksum as jax_packet_checksum
from repro.core.transport import RetryPolicy as JaxRetryPolicy
from repro.core.transport import part_checksum as jax_part_checksum
from repro.core.weightstore import WeightStore as JaxWeightStore

from repro_torch.core import delta
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import EdgeClient, LicenseServer, _mask_packet
from repro_torch.core.pytree_io import flatten_params, unflatten
from repro_torch.core.transport import (ChaosTransport, RetryPolicy, packet_checksum,
                                        part_checksum)
from repro_torch.core.weightstore import WeightStore, to_host
from repro_torch.models.model import params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STORE_KW = dict(row_limit=64, chunk_elems=16)
SHAPES = {
    "a/w": ((10, 10), "bfloat16"),      # chunk mode
    "a/norm_scale": ((12,), "bfloat16"),  # rows, never masked (dynamics, 1-D)
    "b/w": ((8, 16), "float32"),        # chunk mode
    "b/bias": ((3, 7), "float32"),      # rows, 2-D: masked
    "c/w": ((4, 8), "bfloat16"),        # rows, 2-D: masked
}
MASKS = {"*": ((0.0, 0.3),), "b/": ((1.0, 1.5),)}


def _flat(seed, scale=1.0):
    r = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in SHAPES.items():
        a = (r.standard_normal(shape) * scale).astype(np.float32)
        out[name] = a.astype(jnp.bfloat16) if dt == "bfloat16" else a
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        return to_host(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_part(d, e):
    assert (d.layer, tuple(d.shape), d.dtype) == (e.layer, tuple(e.shape), e.dtype)
    np.testing.assert_array_equal(d.indices, e.indices)
    if e.chunks is None:
        assert _bits(d.values).tobytes() == _bits(e.values).tobytes(), d.layer
    else:
        assert d.chunks == e.chunks and d.chunk_flags() == e.chunk_flags()
    assert part_checksum(d) == jax_part_checksum(e)


@pytest.fixture()
def servers():
    """(jax server, port server) with v1 and an increment v2, and tier
    'free' on both."""
    v1, v2 = _flat(1), _flat(2, scale=1.3)
    v2["a/norm_scale"] = v1["a/norm_scale"]            # one untouched layer
    js = JaxLicenseServer(JaxWeightStore(":memory:", **STORE_KW))
    ts = LicenseServer(WeightStore(":memory:", **STORE_KW))
    for flat in (v1, v2):
        js.publish("m", unflatten(dict(flat)))
        ts.publish("m", params_from_jax(flat, device="cpu"))
    js.publish_tier("m", JaxLicenseTier(name="free", masks=MASKS))
    ts.publish_tier("m", LicenseTier(name="free", masks=MASKS))
    return js, ts, v1, v2


@pytest.mark.parametrize("client", [None, 1])
def test_mask_packet_identical(servers, client):
    """Full pull (rows in the layers' own dtypes, bf16 included) and an
    increment (f32 rows, pages): kept entries bit-identical, masked ones
    zero, in both packages."""
    js, ts, _, _ = servers
    tier, jtier = ts.tier("m", "free"), js.tier("m", "free")
    got = _mask_packet(ts.store.delta_since("m", client), tier)
    want = jax_mask_packet(js.store.delta_since("m", client), jtier)
    assert len(got.deltas) == len(want.deltas) > 0
    for d, e in zip(got.deltas, want.deltas):
        _same_part(d, e)
    masked = [d for d in got.deltas if d.values is not None and d.layer == "c/w"]
    assert masked and masked[0].values.dtype == (np.uint16 if client is None
                                                 else np.float32)
    assert (masked[0].values == 0).any()


@pytest.mark.parametrize("max_bytes", [1, 40, 300, 1 << 20])
def test_cursor_parts_identical_with_resume(servers, max_bytes):
    """open_update/fetch_update slice the same parts; a cursor seeked to a
    ``tell`` snapshot continues exactly where the first one was."""
    js, ts, _, _ = servers
    seqs = []
    for server in (ts, js):
        cur = server.open_update("m", 1, "free")
        parts, positions = [], []
        while True:
            positions.append(cur.tell())
            batch = server.fetch_update(cur, max_bytes)
            if not batch:
                break
            parts.append(batch)
        seqs.append((parts, positions, cur.fetched_bytes, cur.fetched_parts))
        i = len(parts) // 2                  # positions[i] precedes parts[i]
        resumed = server.open_update("m", 1, "free", resume=positions[i])
        assert resumed.tell() == positions[i]
        first = server.fetch_update(resumed, max_bytes)
        assert len(first) == len(parts[i])
        for d, e in zip(first, parts[i]):
            _same_part(d, e)
    (tp, tpos, tb, tn), (jp, jpos, jb, jn) = seqs
    assert tpos == jpos and (tb, tn) == (jb, jn)
    assert [len(b) for b in tp] == [len(b) for b in jp]
    for tb_, jb_ in zip(tp, jp):
        for d, e in zip(tb_, jb_):
            _same_part(d, e)
    assert [(x.bytes_sent, x.entries) for x in ts.log] == \
           [(x.bytes_sent, x.entries) for x in js.log]


@pytest.mark.parametrize("license_name", ["full", "free"])
def test_edge_client_pull_identical(servers, license_name):
    """Boot pull (None -> v2) then nothing to do: the port's client ends
    with the JAX client's weights, bit for bit, and the same byte count."""
    js, ts, _, v2 = servers
    template = {k: torch.zeros(v.shape, dtype=(torch.bfloat16 if v.dtype.name
                                                == "bfloat16" else torch.float32))
                for k, v in v2.items()}
    tc = EdgeClient("m", unflatten(template), license_name)
    jc = JaxEdgeClient("m", unflatten({k: np.zeros_like(v) for k, v in v2.items()}),
                       license_name)
    for _ in range(2):
        tc.request_update(ts)
        jc.request_update(js)
    assert (tc.version, tc.updates, tc.bytes_downloaded) == \
           (jc.version, jc.updates, jc.bytes_downloaded) == (2, 1, tc.bytes_downloaded)
    jflat = {k: np.asarray(v) for k, v in flatten_params(jc.params).items()}
    for k, v in flatten_params(tc.params).items():
        assert v.dtype == template[k].dtype
        assert _bits(v).tobytes() == _bits(jflat[k]).tobytes(), k


def _chaos_trace(server, transport_cls, retry_cls, client_cls, template):
    """Drive a fixed call sequence through a chaos transport; record each
    outcome (result summary or exception type) and the counters."""
    t = transport_cls(server, seed=7, fault_rate=0.5, dup_rate=0.3,
                      sleep=lambda s: None)
    trace = []
    for _ in range(6):
        try:
            trace.append(("pv", t.production_version("m")))
        except Exception as e:                       # noqa: BLE001
            trace.append(("pv", type(e).__name__))
    cur = server.open_update("m", 1, "free")
    for _ in range(12):
        try:
            parts = t.fetch_update(cur, 64)
            trace.append(("fetch", [(p.layer, len(p.indices)) for p in parts]))
        except Exception as e:                       # noqa: BLE001
            trace.append(("fetch", type(e).__name__))
    client = client_cls("m", template, "free")
    client.request_update(t, retry=retry_cls(max_attempts=20, sleep=lambda s: None))
    trace.append(("pull", client.version, client.bytes_downloaded))
    return trace, dict(t.stats)


def test_chaos_transport_same_fault_schedule(servers):
    js, ts, _, v2 = servers
    ttemplate = params_from_jax({k: np.zeros_like(v) for k, v in v2.items()},
                                device="cpu")
    jtemplate = unflatten({k: np.zeros_like(v) for k, v in v2.items()})
    got = _chaos_trace(ts, ChaosTransport, RetryPolicy, EdgeClient, ttemplate)
    want = _chaos_trace(js, JaxChaosTransport, JaxRetryPolicy, JaxEdgeClient, jtemplate)
    assert got == want
    assert got[1]["faults"] > 0 and got[1]["duplicates"] > 0


def _same_packet(got, want):
    assert len(got.deltas) == len(want.deltas)
    for d, e in zip(got.deltas, want.deltas):
        _same_part(d, e)
    assert packet_checksum(got) == jax_packet_checksum(want)


def test_encode_delta_identical(servers):
    """The sparse diff of v1 -> v2 (bf16 and f32 layers, one untouched):
    same layers, dtype strings, indices and f32 values in both packages."""
    _, _, v1, v2 = servers
    got = delta.encode_delta(params_from_jax(v1, device="cpu"),
                             params_from_jax(v2, device="cpu"))
    want = jax_delta.encode_delta(unflatten(dict(v1)), unflatten(dict(v2)))
    assert "a/norm_scale" not in [d.layer for d in got.deltas]
    assert {d.dtype for d in got.deltas} == {"bfloat16", "float32"}
    _same_packet(got, want)


@pytest.mark.parametrize("client", [None, 1])
def test_delta_to_dense_identical(servers, client):
    """Full pull (rows, bf16 and f32) and the increment (rows and chunk
    pages): the dense host buffers carry the same bits; bf16 pages stay
    bf16 (as bits in the port), rows come out f32."""
    js, ts, _, _ = servers
    got = ts.store.delta_since("m", client)
    want = js.store.delta_since("m", client)
    kinds = set()
    for d, e in zip(got.deltas, want.deltas):
        a, b = delta.delta_to_dense(d), jax_delta.delta_to_dense(e)
        assert a.shape == b.shape == tuple(e.shape)
        assert _bits(a).tobytes() == _bits(b).tobytes(), d.layer
        kinds.add((d.chunks is not None, d.dtype))
    assert len(got.deltas) == len(want.deltas)
    assert {dt for _, dt in kinds} == {"bfloat16", "float32"}
    assert {c for c, _ in kinds} == ({False} if client is None else {False, True})


@pytest.mark.parametrize("client", [None, 1])
def test_shard_delta_identical(servers, client):
    """One host's flat-index ranges: pages that overlap the range kept
    whole, rows filtered, layers left out of the map shipped whole and
    layers with nothing in range dropped — the same parts and checksum."""
    js, ts, _, _ = servers
    ranges = {"a/w": (20, 70), "b/w": (0, 16), "b/bias": (3, 15), "c/w": (100, 200)}
    whole = ts.store.delta_since("m", client)
    got = delta.shard_delta(whole, ranges)
    want = jax_delta.shard_delta(js.store.delta_since("m", client), ranges)
    _same_packet(got, want)
    layers = [d.layer for d in got.deltas]
    assert "c/w" not in layers and 0 < len(layers) < len(whole.deltas)
    if client is None:                     # untouched by v2, so full pull only
        assert "a/norm_scale" in layers
