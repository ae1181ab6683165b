"""Versioned weight database — the paper's Fig. 4 schema on sqlite3.

Counterpart of ``repro.core.weightstore``, with the same schema, format
version and row/chunk storage rules, so a store file written by either
package opens in the other and answers every query with the same bytes:

* tables ``model``, ``layer``, ``weight``, ``version``, ``accuracy``
  (§3.3, Fig. 4); ``weight`` keeps one row per non-zero changed weight,
  so successive versions share unchanged entries (§3.1.2, §3.4);
* layers above ``row_limit`` elements switch to *chunk mode*: fixed-size
  pages in the layer's own dtype, a new version storing only the pages
  that changed;
* ``delta_since`` answers the client update query of §3.1.2 / §4.2 in
  one query across skipped versions.

The store is server-side: it holds numpy arrays and sqlite rows only.
``commit`` takes the port's parameter dict of tensors on any device (or
numpy arrays) and copies each leaf to the host once.

bfloat16 without ``ml_dtypes``: numpy has no bf16 type, so a bf16 layer
lives on the host as its raw 16-bit patterns, an ``np.uint16`` array
tagged ``"bfloat16"`` (the layer's registered dtype string, as in the
JAX package).  Chunk pages and full-pull values therefore carry exactly
the JAX package's bytes; arithmetic on them (comparisons, row values,
magnitudes) widens the bits to float32 first, which is exact.  In this
package an ``np.uint16`` weight array always means bf16 bits.
"""
from __future__ import annotations

import hashlib
import json
import sqlite3
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pytree_io import flatten_params, unflatten_like

_SCHEMA = """
CREATE TABLE IF NOT EXISTS model (
    id INTEGER PRIMARY KEY,
    name TEXT UNIQUE NOT NULL,
    arch TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS layer (
    id INTEGER PRIMARY KEY,
    model_fk INTEGER NOT NULL REFERENCES model(id),
    name TEXT NOT NULL,
    layer_index INTEGER NOT NULL,
    shape TEXT NOT NULL,
    dtype TEXT NOT NULL,
    storage TEXT NOT NULL DEFAULT 'rows',   -- 'rows' | 'chunks'
    UNIQUE(model_fk, name)
);
CREATE TABLE IF NOT EXISTS version (
    id INTEGER PRIMARY KEY,
    model_fk INTEGER NOT NULL REFERENCES model(id),
    parent_fk INTEGER REFERENCES version(id),
    tag TEXT,
    message TEXT,
    is_major INTEGER NOT NULL DEFAULT 0,
    is_production INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS weight (
    id INTEGER PRIMARY KEY,
    layer_fk INTEGER NOT NULL REFERENCES layer(id),
    version_fk INTEGER NOT NULL REFERENCES version(id),
    flat_index INTEGER NOT NULL,
    value REAL NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS weight_layer_version ON weight(layer_fk, version_fk);
CREATE TABLE IF NOT EXISTS weight_chunk (
    id INTEGER PRIMARY KEY,
    layer_fk INTEGER NOT NULL REFERENCES layer(id),
    version_fk INTEGER NOT NULL REFERENCES version(id),
    chunk_index INTEGER NOT NULL,
    hash TEXT NOT NULL,
    data BLOB NOT NULL,
    nbytes INTEGER NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS chunk_layer_version ON weight_chunk(layer_fk, version_fk);
CREATE TABLE IF NOT EXISTS accuracy (
    id INTEGER PRIMARY KEY,
    model_fk INTEGER NOT NULL REFERENCES model(id),
    version_fk INTEGER NOT NULL REFERENCES version(id),
    tier_name TEXT NOT NULL,
    accuracy REAL NOT NULL,
    masks TEXT NOT NULL,           -- JSON: {layer_pattern: [[lo, hi], ...]}
    created_at REAL NOT NULL,
    UNIQUE(model_fk, tier_name)
);
"""


# ------------------------------------------------------------- host dtypes
def host_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a layer registered as ``name`` on the
    host: bf16 as its raw bits (``np.uint16``), everything else itself."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """Widen bf16 bit patterns to float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 bit patterns, to nearest even — what
    ``ml_dtypes``' ``astype(bfloat16)`` and torch's ``.to(bfloat16)`` do;
    NaNs stay NaNs (quietened, sign kept)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = ((u >> 16) & 1) + np.uint32(0x7FFF)
    out = ((u + bias) >> 16).astype(np.uint16)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    if nan.any():
        out[nan] = ((u[nan] >> 16) | 0x0040).astype(np.uint16)
    return out


def as_float32(arr: np.ndarray) -> np.ndarray:
    """A host weight array in float32: bf16 bits widened, others cast."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        return bf16_to_f32(arr)
    return arr.astype(np.float32, copy=False)


def cast_host(arr: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Convert a host array registered as ``src`` to ``dst`` (``astype``
    semantics, bf16 rounding to nearest even)."""
    if src == dst:
        return arr
    if dst == "bfloat16":
        return f32_to_bf16(as_float32(arr)).reshape(np.shape(arr))
    return (bf16_to_f32(arr) if src == "bfloat16" else arr).astype(dst)


def nonzero(arr: np.ndarray) -> np.ndarray:
    """Flat indices of the non-zero entries: for bf16 bits, every pattern
    but +0 and -0 (numpy's truthiness of the real values)."""
    arr = np.asarray(arr).reshape(-1)
    if arr.dtype == np.uint16:
        return np.flatnonzero(arr & 0x7FFF)
    return np.flatnonzero(arr)


def to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """One parameter leaf (tensor on any device, or array) as a host
    array plus its dtype string; bf16 tensors come back as their bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        return t.cpu().numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; bf16 bits become a
    ``torch.bfloat16`` view of the same bytes."""
    arr = np.require(arr, requirements=("C", "W"))
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# ------------------------------------------------------------- wire types
@dataclass
class LayerDelta:
    """Sparse update for one layer: values at flat indices (or whole chunks).

    Chunk pages are encoded in the layer's ``dtype`` (decode with
    :meth:`iter_pages`), and whether each page payload is zlib-compressed
    is carried explicitly in ``chunk_compressed`` — one flag per entry of
    ``chunks``; receivers never sniff compression.  Rows-mode ``values``
    are float32 for an incremental delta and the layer's own dtype (bf16
    as bits) for a full snapshot, as in the JAX package.
    """

    layer: str
    shape: Tuple[int, ...]
    dtype: str
    indices: np.ndarray          # int64 flat indices (rows mode) or chunk ids
    values: Optional[np.ndarray] = None   # rows mode: scalar per index
    chunks: Optional[List[bytes]] = None  # chunks mode: raw page payloads
    chunk_elems: int = 0
    chunk_compressed: Optional[List[bool]] = None  # per-chunk zlib flag

    @property
    def nbytes(self) -> int:
        if self.chunks is not None:
            return int(sum(len(c) for c in self.chunks) + self.indices.nbytes)
        return int(self.indices.nbytes + self.values.nbytes)

    def chunk_flags(self) -> List[bool]:
        """Per-chunk compression flags (all-False when never set)."""
        if self.chunks is None:
            return []
        if self.chunk_compressed is None:
            return [False] * len(self.chunks)
        return list(self.chunk_compressed)

    def iter_pages(self):
        """Yield ``(chunk_index, page)`` per chunk, decoded in this
        delta's dtype (bf16 as bits) under its explicit compression flags."""
        if self.chunks is None:
            return
        dt = host_dtype(self.dtype)
        for ci, payload, comp in zip(self.indices, self.chunks,
                                     self.chunk_flags()):
            raw = zlib.decompress(payload) if comp else payload
            yield int(ci), np.frombuffer(raw, dtype=dt)


@dataclass
class UpdatePacket:
    """Server -> client payload for one update request (§3.1.2)."""

    model: str
    from_version: Optional[int]
    to_version: int
    deltas: List[LayerDelta] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return sum(d.nbytes for d in self.deltas)

    @property
    def num_entries(self) -> int:
        return int(sum(len(d.indices) for d in self.deltas))


def _pages_equal(page: np.ndarray, old: np.ndarray) -> bool:
    """``np.array_equal`` of the real values (bf16 bits compared as
    floats: +0 == -0, NaN never equal)."""
    if page.size != old.size:
        return False
    if page.dtype != np.uint16:
        return np.array_equal(page, old)
    if np.array_equal(page, old):
        return not ((page & 0x7FFF) > 0x7F80).any()
    return np.array_equal(bf16_to_f32(page), bf16_to_f32(old))


class WeightStore:
    """sqlite3-backed versioned weight store (paper Fig. 4)."""

    # bumped to 2 when chunk pages switched from always-f32 to the
    # layer's registered dtype; see _check_chunk_encoding
    _FORMAT_VERSION = 2

    def __init__(
        self,
        path: str = ":memory:",
        *,
        row_limit: int = 262_144,
        chunk_elems: int = 65_536,
        compress_chunks: bool = True,
    ):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.path = path
        self.row_limit = int(row_limit)
        self.chunk_elems = int(chunk_elems)
        self.compress_chunks = compress_chunks
        self._check_chunk_encoding()

    def _check_chunk_encoding(self) -> None:
        """Refuse to silently misread a pre-format-2 store (format 1
        encoded every chunk page as float32); f32-only stores are stamped
        forward."""
        ver, = self.conn.execute("PRAGMA user_version").fetchone()
        if ver >= self._FORMAT_VERSION:
            return
        row = self.conn.execute(
            "SELECT l.name, l.dtype FROM layer l WHERE l.storage='chunks'"
            " AND l.dtype <> 'float32' AND EXISTS"
            " (SELECT 1 FROM weight_chunk c WHERE c.layer_fk=l.id) LIMIT 1"
        ).fetchone()
        if row is not None:
            raise RuntimeError(
                f"weight store {self.path!r} was written by format 1 "
                f"(chunk pages always float32) but layer {row[0]!r} is "
                f"registered as {row[1]!r}; re-commit the model with this "
                f"version to migrate — decoding would corrupt it")
        self.conn.execute(f"PRAGMA user_version={self._FORMAT_VERSION}")
        self.conn.commit()

    # ------------------------------------------------------------------ model
    def register_model(self, name: str, arch: str = "generic") -> int:
        cur = self.conn.execute(
            "INSERT OR IGNORE INTO model(name, arch, created_at) VALUES (?,?,?)",
            (name, arch, time.time()),
        )
        self.conn.commit()
        if cur.lastrowid:
            return cur.lastrowid
        return self._model_id(name)

    def _model_id(self, name: str) -> int:
        row = self.conn.execute("SELECT id FROM model WHERE name=?", (name,)).fetchone()
        if row is None:
            raise KeyError(f"unknown model {name!r}")
        return row[0]

    def _layer_id(self, model_id: int, name: str) -> Tuple[int, Tuple[int, ...], str, str]:
        row = self.conn.execute(
            "SELECT id, shape, dtype, storage FROM layer WHERE model_fk=? AND name=?",
            (model_id, name),
        ).fetchone()
        if row is None:
            raise KeyError(f"unknown layer {name!r}")
        return row[0], tuple(json.loads(row[1])), row[2], row[3]

    def _ensure_layers(self, model_id: int,
                       flat: Dict[str, Tuple[np.ndarray, str]]) -> None:
        for i, (name, (arr, dt)) in enumerate(flat.items()):
            storage = "chunks" if arr.size > self.row_limit else "rows"
            self.conn.execute(
                "INSERT OR IGNORE INTO layer(model_fk, name, layer_index, shape, dtype, storage)"
                " VALUES (?,?,?,?,?,?)",
                (model_id, name, i, json.dumps(list(arr.shape)), dt, storage),
            )

    # ---------------------------------------------------------------- commits
    def commit(
        self,
        model: str,
        params,
        *,
        parent: Optional[int] = None,
        tag: Optional[str] = None,
        message: str = "",
        major: bool = False,
        set_production: bool = True,
        store_zeros: bool = False,
    ) -> int:
        """Store a new version.  Only weights that changed vs ``parent`` get
        new rows (paper §3.1.2); pruned zeros are skipped unless
        ``store_zeros`` (paper §3.3: "only the nonzero weights")."""
        model_id = self._model_id(model) if self._exists(model) else self.register_model(model)
        flat = {name: to_host(leaf) for name, leaf in flatten_params(params).items()}
        self._ensure_layers(model_id, flat)

        if parent is None:
            parent = self.production_version(model, missing_ok=True)
        parent_flat = (
            self._reconstruct(model_id, parent) if parent is not None and not major else {}
        )

        now = time.time()
        cur = self.conn.execute(
            "INSERT INTO version(model_fk, parent_fk, tag, message, is_major, created_at)"
            " VALUES (?,?,?,?,?,?)",
            (model_id, None if major else parent, tag, message, int(major), now),
        )
        version_id = cur.lastrowid

        for name, (arr, src) in flat.items():
            layer_id, _, dtype, storage = self._layer_id(model_id, name)
            old = parent_flat.get(name)
            if storage == "rows":
                flat_arr = as_float32(arr).reshape(-1)
                self._commit_rows(layer_id, version_id, flat_arr, old, store_zeros, now)
            else:
                # chunk pages are encoded in the layer's registered dtype
                flat_arr = cast_host(arr, src, dtype).reshape(-1)
                self._commit_chunks(layer_id, version_id, flat_arr, old, now)

        if set_production:
            self._set_production(model_id, version_id)
        self.conn.commit()
        return version_id

    def _commit_rows(self, layer_id, version_id, flat_arr, old, store_zeros, now) -> None:
        # the parent's rows were staged in f32, so widening is exact
        old_f = None if old is None else as_float32(old).reshape(-1)
        if old_f is None:
            changed = np.arange(flat_arr.size, dtype=np.int64)
        else:
            changed = np.nonzero(flat_arr != old_f)[0]
        if not store_zeros:
            changed = changed[flat_arr[changed] != 0.0]
            # a weight that *became* zero must still be recorded as a change
            if old_f is not None:
                zeroed = np.nonzero((flat_arr == 0.0) & (old_f != 0.0))[0]
                changed = np.union1d(changed, zeroed)
        rows = [(layer_id, version_id, i, v, now)
                for i, v in zip(changed.tolist(), flat_arr[changed].tolist())]
        self.conn.executemany(
            "INSERT INTO weight(layer_fk, version_fk, flat_index, value, created_at)"
            " VALUES (?,?,?,?,?)",
            rows,
        )

    def _commit_chunks(self, layer_id, version_id, flat_arr, old, now) -> None:
        ce = self.chunk_elems
        n_chunks = -(-flat_arr.size // ce)
        old_flat = None if old is None else old.reshape(-1)
        rows = []
        for ci in range(n_chunks):
            page = flat_arr[ci * ce : (ci + 1) * ce]
            if old_flat is not None and _pages_equal(page, old_flat[ci * ce : (ci + 1) * ce]):
                continue
            payload = page.tobytes()
            if self.compress_chunks:
                payload = zlib.compress(payload, level=1)
            h = hashlib.sha1(payload).hexdigest()
            rows.append((layer_id, version_id, ci, h, payload, len(payload), now))
        self.conn.executemany(
            "INSERT INTO weight_chunk(layer_fk, version_fk, chunk_index, hash, data, nbytes,"
            " created_at) VALUES (?,?,?,?,?,?,?)",
            rows,
        )

    def _exists(self, model: str) -> bool:
        return (
            self.conn.execute("SELECT 1 FROM model WHERE name=?", (model,)).fetchone()
            is not None
        )

    # --------------------------------------------------------------- versions
    def history(self, model: str) -> List[dict]:
        model_id = self._model_id(model)
        rows = self.conn.execute(
            "SELECT id, parent_fk, tag, message, is_major, is_production, created_at"
            " FROM version WHERE model_fk=? ORDER BY id",
            (model_id,),
        ).fetchall()
        keys = ("id", "parent", "tag", "message", "is_major", "is_production", "created_at")
        return [dict(zip(keys, r)) for r in rows]

    def production_version(self, model: str, missing_ok: bool = False) -> Optional[int]:
        model_id = self._model_id(model)
        row = self.conn.execute(
            "SELECT id FROM version WHERE model_fk=? AND is_production=1", (model_id,)
        ).fetchone()
        if row is None:
            if missing_ok:
                return None
            raise KeyError(f"no production version for {model!r}")
        return row[0]

    def _set_production(self, model_id: int, version_id: int) -> None:
        self.conn.execute(
            "UPDATE version SET is_production=0 WHERE model_fk=?", (model_id,)
        )
        self.conn.execute(
            "UPDATE version SET is_production=1 WHERE id=?", (version_id,)
        )

    def rollback(self, model: str, version: int) -> None:
        """Paper §3.4: rollback = repoint the production flag."""
        model_id = self._model_id(model)
        row = self.conn.execute(
            "SELECT 1 FROM version WHERE id=? AND model_fk=?", (version, model_id)
        ).fetchone()
        if row is None:
            raise KeyError(f"version {version} does not belong to model {model!r}")
        self._set_production(model_id, version)
        self.conn.commit()

    def _ancestry(self, version_id: int) -> List[int]:
        """Root-first chain of versions ending at ``version_id``."""
        chain = []
        cur: Optional[int] = version_id
        while cur is not None:
            chain.append(cur)
            row = self.conn.execute(
                "SELECT parent_fk, is_major FROM version WHERE id=?", (cur,)
            ).fetchone()
            if row is None:
                raise KeyError(f"unknown version {cur}")
            parent, is_major = row
            cur = None if is_major else parent
        return chain[::-1]

    # --------------------------------------------------------------- checkout
    def checkout(self, model: str, version: Optional[int] = None, template=None):
        """Reconstruct full params at ``version`` (default: production) as
        host arrays (bf16 as bits); with ``template``, in its nested
        structure.  Paper §3.3: a zeroed model layer by layer, stored
        values placed at their flat indices, replaying the ancestor chain
        so minor versions inherit unchanged weights."""
        model_id = self._model_id(model)
        if version is None:
            version = self.production_version(model)
        flat = self._reconstruct(model_id, version)
        if template is not None:
            return unflatten_like(template, flat)
        return flat

    def _reconstruct(self, model_id: int, version_id: int) -> Dict[str, np.ndarray]:
        chain = self._ancestry(version_id)
        layers = self.conn.execute(
            "SELECT id, name, shape, dtype, storage FROM layer WHERE model_fk=?"
            " ORDER BY layer_index",
            (model_id,),
        ).fetchall()
        out: Dict[str, np.ndarray] = {}
        for layer_id, name, shape, dtype, storage in layers:
            shape = tuple(json.loads(shape))
            size = int(np.prod(shape)) if shape else 1
            # chunk pages are stored bit-exact in the layer's dtype; rows
            # values are sqlite REALs, staged in f32 as the JAX package does
            buf = np.zeros(size, dtype=host_dtype(dtype) if storage == "chunks"
                           else np.float32)
            for v in chain:
                if storage == "rows":
                    rows = self.conn.execute(
                        "SELECT flat_index, value FROM weight WHERE layer_fk=? AND version_fk=?",
                        (layer_id, v),
                    ).fetchall()
                    if rows:
                        idx = np.fromiter((r[0] for r in rows), dtype=np.int64, count=len(rows))
                        val = np.fromiter((r[1] for r in rows), dtype=np.float32, count=len(rows))
                        buf[idx] = val
                else:
                    rows = self.conn.execute(
                        "SELECT chunk_index, data FROM weight_chunk"
                        " WHERE layer_fk=? AND version_fk=?",
                        (layer_id, v),
                    ).fetchall()
                    ce = self.chunk_elems
                    for ci, payload in rows:
                        raw = zlib.decompress(payload) if self.compress_chunks else payload
                        page = np.frombuffer(raw, dtype=host_dtype(dtype))
                        buf[ci * ce : ci * ce + page.size] = page
            # layers with all-zero weights are legal (fully pruned)
            src = dtype if storage == "chunks" else "float32"
            out[name] = cast_host(buf, src, dtype).reshape(shape)
        return out

    # ------------------------------------------------------------------ delta
    def delta_since(
        self, model: str, client_version: Optional[int], target: Optional[int] = None
    ) -> UpdatePacket:
        """All weights changed after ``client_version`` up to ``target``
        (default: production) — one query across skipped patches (§4.2)."""
        model_id = self._model_id(model)
        if target is None:
            target = self.production_version(model)
        packet = UpdatePacket(model=model, from_version=client_version, to_version=target)
        if client_version == target:
            return packet

        chain = self._ancestry(target)
        if client_version is not None and client_version in chain:
            new_versions = chain[chain.index(client_version) + 1 :]
            full = False
        else:
            # client is on a different branch (or None): ship a full snapshot
            new_versions = chain
            full = True

        layers = self.conn.execute(
            "SELECT id, name, shape, dtype, storage FROM layer WHERE model_fk=?"
            " ORDER BY layer_index",
            (model_id,),
        ).fetchall()
        if full:
            flat = self._reconstruct(model_id, target)
            for layer_id, name, shape, dtype, storage in layers:
                # the full snapshot ships rows in the layer's own dtype
                arr = flat.pop(name).reshape(-1)
                nz = nonzero(arr)
                packet.deltas.append(
                    LayerDelta(
                        layer=name, shape=tuple(json.loads(shape)), dtype=dtype,
                        indices=nz.astype(np.int64, copy=False), values=arr[nz],
                    )
                )
            return packet

        qmarks = ",".join("?" * len(new_versions))
        for layer_id, name, shape, dtype, storage in layers:
            shape_t = tuple(json.loads(shape))
            if storage == "rows":
                rows = self.conn.execute(
                    f"SELECT flat_index, value, version_fk FROM weight"
                    f" WHERE layer_fk=? AND version_fk IN ({qmarks}) ORDER BY version_fk",
                    (layer_id, *new_versions),
                ).fetchall()
                if not rows:
                    continue
                last: Dict[int, float] = {}
                for fi, val, _v in rows:  # later versions override earlier
                    last[fi] = val
                idx = np.array(sorted(last), dtype=np.int64)
                val = np.array([last[i] for i in idx], dtype=np.float32)
                packet.deltas.append(
                    LayerDelta(layer=name, shape=shape_t, dtype=dtype, indices=idx, values=val)
                )
            else:
                rows = self.conn.execute(
                    f"SELECT chunk_index, data, version_fk FROM weight_chunk"
                    f" WHERE layer_fk=? AND version_fk IN ({qmarks}) ORDER BY version_fk",
                    (layer_id, *new_versions),
                ).fetchall()
                if not rows:
                    continue
                last_c: Dict[int, bytes] = {}
                for ci, data, _v in rows:
                    last_c[ci] = data
                idx = np.array(sorted(last_c), dtype=np.int64)
                packet.deltas.append(
                    LayerDelta(
                        layer=name, shape=shape_t, dtype=dtype, indices=idx,
                        chunks=[last_c[int(i)] for i in idx], chunk_elems=self.chunk_elems,
                        chunk_compressed=[self.compress_chunks] * len(idx),
                    )
                )
        return packet

    # ------------------------------------------------------------- accounting
    def storage_bytes(self, model: str) -> Dict[str, int]:
        """Bytes attributable to this model's stored weights (paper Table 1):
        ``row_bytes`` counts 8 B index + 8 B REAL per weight row,
        ``payload`` adds the (compressed) chunk pages."""
        model_id = self._model_id(model)
        n_rows, = self.conn.execute(
            "SELECT COUNT(*) FROM weight w JOIN layer l ON w.layer_fk=l.id"
            " WHERE l.model_fk=?",
            (model_id,),
        ).fetchone()
        chunk_bytes, = self.conn.execute(
            "SELECT COALESCE(SUM(c.nbytes),0) FROM weight_chunk c JOIN layer l"
            " ON c.layer_fk=l.id WHERE l.model_fk=?",
            (model_id,),
        ).fetchone()
        return {
            "weight_rows": int(n_rows),
            "row_bytes": int(n_rows) * 16,  # 8B flat_index + 8B REAL value
            "chunk_bytes": int(chunk_bytes),
            "payload": int(n_rows) * 16 + int(chunk_bytes),
        }

    # ------------------------------------------------------------- accuracies
    def register_tier(
        self, model: str, version: int, tier_name: str, accuracy: float,
        masks: Dict[str, Sequence[Tuple[float, float]]],
    ) -> None:
        model_id = self._model_id(model)
        self.conn.execute(
            "INSERT OR REPLACE INTO accuracy(model_fk, version_fk, tier_name, accuracy,"
            " masks, created_at) VALUES (?,?,?,?,?,?)",
            (model_id, version, tier_name, accuracy,
             json.dumps({k: [list(iv) for iv in v] for k, v in masks.items()}),
             time.time()),
        )
        self.conn.commit()

    def get_tier(self, model: str, tier_name: str) -> Tuple[float, Dict[str, list]]:
        model_id = self._model_id(model)
        row = self.conn.execute(
            "SELECT accuracy, masks FROM accuracy WHERE model_fk=? AND tier_name=?",
            (model_id, tier_name),
        ).fetchone()
        if row is None:
            raise KeyError(f"no tier {tier_name!r} for model {model!r}")
        return row[0], {k: [tuple(iv) for iv in v] for k, v in json.loads(row[1]).items()}

    def list_tiers(self, model: str) -> List[Tuple[str, float]]:
        model_id = self._model_id(model)
        rows = self.conn.execute(
            "SELECT tier_name, accuracy FROM accuracy WHERE model_fk=? ORDER BY accuracy DESC",
            (model_id,),
        ).fetchall()
        return [(r[0], r[1]) for r in rows]

    def close(self) -> None:
        self.conn.close()
