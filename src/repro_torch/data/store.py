"""On-disk partitioned transaction store — the repo's HDFS.

The paper's substrate is a DB *split into HDFS blocks*: no node ever holds
the whole dataset, mappers stream their block, and the namenode only keeps
metadata. This module is that substrate for the miner: a directory of
fixed-row **shards** of packed uint32 bitsets (DESIGN.md §4 layout, 1 bit
per cell) saved as ``.npy`` files, plus a JSON **manifest** recording the
logical shape (``n``, ``num_items``), the per-shard row counts, and a
layout version. Shards open memory-mapped, so reading a chunk touches only
that chunk's pages — host peak RSS during mining is bounded by the chunk
size, not the dataset size (DESIGN.md §9).

Ingest paths (all route through :class:`StoreWriter`, which buffers at most
one shard of rows):

  * :func:`ingest_dense`        — an in-memory {0,1} matrix (tests, small DBs)
  * :func:`ingest_lists`        — transaction lists of item ids
  * :func:`ingest_chunks`       — any iterator of dense or packed row chunks
  * :func:`ingest_quest`        — a chunked QuestConfig generator
                                  (``data.synthetic.gen_transactions_chunked``),
                                  so huge synthetic DBs never materialize

Read path: :meth:`TransactionStore.iter_chunks` yields fixed-size row
chunks (packed uint32 or unpacked dense int8) assembled across shard
boundaries; ``pad=True`` zero-pads the final chunk to the full chunk size —
zero rows are inert for support counting in both representations
(DESIGN.md §3), which is what lets the streaming miner keep one chunk shape.

This is the PyTorch port's copy of the JAX package's store, numpy only.
The on-disk format is the same byte for byte (``.npy`` shards, manifest
JSON, :data:`LAYOUT_VERSION`), so a store written by either package opens in
the other.  Chunks and partitions come back as numpy arrays, and
``iter_chunks`` may hand out a read-only view of a shard's mmap: a consumer
copies it (``data.pipeline`` copies each chunk into a pinned buffer).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core import itemsets as enc

LAYOUT_VERSION = 1
LAYOUT_NAME = "packed-u32-le"   # uint32 words, little-endian bit order (§4)
MANIFEST_NAME = "manifest.json"


DEFAULT_CHECKPOINT_DIR = "_checkpoints"


@dataclasses.dataclass(frozen=True)
class StoreManifest:
    """The namenode metadata: logical shape + physical shard layout.

    ``checkpoint_dir`` points (relative to the store directory) at where
    mining checkpoints for this store live — resume tooling finds the
    snapshots next to the data they were taken over (DESIGN.md §11).
    Manifests written before the field existed read back with the default.

    ``seq`` is the manifest generation: it bumps on every manifest rewrite
    (shard append, count-cache refresh), so readers can tell "same directory,
    new contents" apart from "unchanged". ``count_cache`` is the optional
    incremental-mining section (DESIGN.md §15): metadata for the persisted
    SON phase-1/2 count cache, whose arrays live in a sidecar ``.npz`` the
    section points at. Appends preserve the section verbatim — the cache
    records which shard prefix it covers, so the delta miner can validate it
    against a grown store.
    """

    version: int
    layout: str
    n: int                      # logical transaction count (sum of shard_rows)
    num_items: int
    words: int                  # packed words per row == packed_words(num_items)
    shard_rows: tuple           # rows per shard, in order
    checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR
    seq: int = 0                # manifest generation; bumps on every rewrite
    count_cache: dict | None = None   # incremental count-cache section (§15)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shard_rows"] = list(self.shard_rows)
        return d

    @staticmethod
    def from_json(d: dict) -> "StoreManifest":
        return StoreManifest(
            version=int(d["version"]),
            layout=str(d["layout"]),
            n=int(d["n"]),
            num_items=int(d["num_items"]),
            words=int(d["words"]),
            shard_rows=tuple(int(r) for r in d["shard_rows"]),
            checkpoint_dir=str(d.get("checkpoint_dir", DEFAULT_CHECKPOINT_DIR)),
            seq=int(d.get("seq", 0)),
            count_cache=d.get("count_cache"),
        )


def _write_manifest(path: str, manifest: StoreManifest) -> None:
    """Atomic manifest (re)write: temp file + ``os.replace``, so a reader (or
    a crash) never observes a torn manifest — it sees the old one or the new
    one, nothing in between. This is what makes appends torn-append-safe:
    shard files land first, and only this single atomic rename publishes them.
    """
    final = os.path.join(path, MANIFEST_NAME)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest.to_json(), f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def shard_filename(index: int) -> str:
    return f"shard_{index:05d}.npy"


class TransactionStore:
    """Read handle over an ingested store directory (shards open mmap'd)."""

    def __init__(self, path: str, manifest: StoreManifest):
        self.path = path
        self.manifest = manifest

    # ------------------------------------------------------------ metadata --
    @property
    def num_transactions(self) -> int:
        return self.manifest.n

    @property
    def num_items(self) -> int:
        return self.manifest.num_items

    @property
    def num_partitions(self) -> int:
        return len(self.manifest.shard_rows)

    def shard_path(self, index: int) -> str:
        return os.path.join(self.path, shard_filename(index))

    @property
    def checkpoint_path(self) -> str:
        """Where this store's mining checkpoints live (manifest pointer)."""
        return os.path.join(self.path, self.manifest.checkpoint_dir)

    # ----------------------------------------------------------- count cache --
    @property
    def count_cache_meta(self) -> dict | None:
        """The manifest's incremental count-cache section, or None (§15)."""
        return self.manifest.count_cache

    def set_count_cache(self, meta: dict | None) -> None:
        """Publish (or clear) the count-cache section: atomic manifest rewrite
        with a ``seq`` bump. Callers write the sidecar arrays FIRST, then call
        this — a crash in between leaves the previous manifest (and previous
        cache pointer) fully readable."""
        old_file = (self.manifest.count_cache or {}).get("file")
        self.manifest = dataclasses.replace(
            self.manifest, seq=self.manifest.seq + 1, count_cache=meta
        )
        _write_manifest(self.path, self.manifest)
        # GC the superseded sidecar only after the new manifest is durable
        new_file = (meta or {}).get("file")
        if old_file and old_file != new_file:
            try:
                os.remove(os.path.join(self.path, old_file))
            except OSError:
                pass

    # ---------------------------------------------------------- partitions --
    def partition_packed(self, index: int) -> np.ndarray:
        """One shard as a read-only memory-mapped (rows, words) uint32 array."""
        arr = np.load(self.shard_path(index), mmap_mode="r")
        rows = self.manifest.shard_rows[index]
        if arr.shape != (rows, self.manifest.words) or arr.dtype != np.uint32:
            raise ValueError(
                f"shard {index} shape/dtype {arr.shape}/{arr.dtype} does not match "
                f"manifest ({rows}, {self.manifest.words}) uint32"
            )
        return arr

    def partition_dense(self, index: int) -> np.ndarray:
        """One shard unpacked to dense {0,1} int8 (materializes ONE shard)."""
        return enc.unpack_bits(np.asarray(self.partition_packed(index)), self.num_items)

    # -------------------------------------------------------------- chunks --
    def iter_chunks(
        self,
        chunk_rows: int,
        representation: str = "packed",
        pad: bool = False,
        start_chunk: int = 0,
        shards: tuple | None = None,
    ):
        """Yield ``(chunk, valid_rows)`` covering all n rows in order.

        chunk: (chunk_rows or fewer, words) uint32 when ``representation ==
        "packed"``, (rows, num_items) int8 when ``"dense"``. Chunks are
        assembled across shard boundaries, copying only the sliced rows out
        of the mmap. With ``pad=True`` every chunk has exactly
        ``chunk_rows`` rows, the tail zero-filled (inert, DESIGN.md §3).

        ``start_chunk`` seeks: the first ``start_chunk`` chunks are skipped
        WITHOUT copying their rows (whole shards before the cursor are never
        even opened), and the yielded sequence is identical to dropping that
        prefix of a full iteration — the resume cursor of DESIGN.md §11.
        Chunk indices are deterministic for a fixed ``chunk_rows``: chunk i
        is always rows ``[i*chunk_rows, (i+1)*chunk_rows)``.

        ``shards=(s0, s1)`` restricts iteration to the half-open shard range
        ``[s0, s1)`` — the delta miner's view (§15): chunk indices (and the
        row coordinates above) are then local to the range, and shards
        outside it are never opened.
        """
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        if start_chunk < 0:
            raise ValueError("start_chunk must be >= 0")
        if representation not in ("packed", "dense"):
            raise ValueError(f"representation must be packed|dense, got {representation!r}")
        s0, s1 = (0, self.num_partitions) if shards is None else shards
        if not (0 <= s0 <= s1 <= self.num_partitions):
            raise ValueError(
                f"shards must satisfy 0 <= s0 <= s1 <= {self.num_partitions}, got {(s0, s1)}"
            )
        total = sum(self.manifest.shard_rows[s0:s1])
        skip = start_chunk * chunk_rows
        if skip >= total:
            return
        parts: list[np.ndarray] = []
        have = 0
        for s in range(s0, s1):
            if skip >= self.manifest.shard_rows[s]:
                skip -= self.manifest.shard_rows[s]
                continue
            shard = self.partition_packed(s)
            pos, skip = skip, 0
            while pos < shard.shape[0]:
                take = min(chunk_rows - have, shard.shape[0] - pos)
                parts.append(np.asarray(shard[pos : pos + take]))
                have += take
                pos += take
                if have == chunk_rows:
                    yield self._emit(parts, have, chunk_rows, representation, pad)
                    parts, have = [], 0
        if have:
            yield self._emit(parts, have, chunk_rows, representation, pad)

    def _emit(self, parts, have, chunk_rows, representation, pad):
        packed = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if pad and have < chunk_rows:
            packed = np.concatenate(
                [packed, np.zeros((chunk_rows - have, packed.shape[1]), np.uint32)]
            )
        if representation == "dense":
            return enc.unpack_bits(packed, self.num_items), have
        return packed, have

    def read_dense(self) -> np.ndarray:
        """The whole DB as dense {0,1} int8 — test/debug helper ONLY; this is
        exactly the materialization the store exists to avoid."""
        return np.concatenate([self.partition_dense(s) for s in range(self.num_partitions)])


class StoreWriter:
    """Streaming ingest: buffers at most one shard of packed rows in RAM,
    flushing each full shard to its own ``.npy``. Context-managed; the
    manifest is written on :meth:`close` (a crashed ingest leaves no
    manifest, so :func:`open_store` refuses the partial directory)."""

    def __init__(self, path: str, num_items: int, shard_rows: int = 8192):
        if shard_rows < 1:
            raise ValueError("shard_rows must be >= 1")
        if num_items < 1:
            raise ValueError("num_items must be >= 1")
        os.makedirs(path, exist_ok=True)
        # re-ingest: invalidate the old store first — manifest AND shards
        # (a smaller re-ingest must not leave orphan shard files behind)
        stale = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(stale):
            os.remove(stale)
        for name in os.listdir(path):
            if name.startswith("shard_") and name.endswith(".npy"):
                os.remove(os.path.join(path, name))
        self.path = path
        self.num_items = num_items
        self.words = enc.packed_words(num_items)
        self.shard_rows = shard_rows
        self._buf: list[np.ndarray] = []
        self._buf_rows = 0
        self._shards: list[int] = []
        self._closed = False
        self._base: StoreManifest | None = None   # set in append mode only

    @classmethod
    def open_for_append(cls, path: str, shard_rows: int | None = None) -> "StoreWriter":
        """Reopen an existing store to append shards (DESIGN.md §15).

        Existing shard files are never rewritten: appended rows always start
        a NEW shard (the last base shard may stay partial — ``shard_rows`` is
        per-shard in the manifest, so readers don't care). New shard files
        land on disk as they fill; only :meth:`close` publishes them, via one
        atomic manifest rewrite with a ``seq`` bump. A crash before close
        (torn append) therefore leaves the old manifest — and the old logical
        store — fully readable; the orphaned shard files it may leave behind
        are swept here on the next append open.
        """
        base = open_store(path)   # validates version/layout/words
        m = base.manifest
        w = cls.__new__(cls)
        w.path = path
        w.num_items = m.num_items
        w.words = m.words
        w.shard_rows = shard_rows or (max(m.shard_rows) if m.shard_rows else 8192)
        if w.shard_rows < 1:
            raise ValueError("shard_rows must be >= 1")
        w._buf, w._buf_rows = [], 0
        w._shards = list(m.shard_rows)
        w._closed = False
        w._base = m
        # sweep orphan shards from a previous torn append (files past the
        # manifest's shard list were written but never published)
        i = len(w._shards)
        while os.path.exists(os.path.join(path, shard_filename(i))):
            os.remove(os.path.join(path, shard_filename(i)))
            i += 1
        return w

    # ------------------------------------------------------------- appends --
    def append_packed(self, packed_chunk: np.ndarray) -> None:
        packed_chunk = np.ascontiguousarray(packed_chunk, dtype=np.uint32)
        if packed_chunk.ndim != 2 or packed_chunk.shape[1] != self.words:
            raise ValueError(
                f"packed chunk must be (rows, {self.words}), got {packed_chunk.shape}"
            )
        pos = 0
        while pos < packed_chunk.shape[0]:
            take = min(self.shard_rows - self._buf_rows, packed_chunk.shape[0] - pos)
            self._buf.append(packed_chunk[pos : pos + take])
            self._buf_rows += take
            pos += take
            if self._buf_rows == self.shard_rows:
                self._flush()

    def append_dense(self, dense_chunk: np.ndarray) -> None:
        dense_chunk = np.asarray(dense_chunk)
        if dense_chunk.ndim != 2 or dense_chunk.shape[1] != self.num_items:
            raise ValueError(
                f"dense chunk must be (rows, {self.num_items}), got {dense_chunk.shape}"
            )
        self.append_packed(enc.pack_bits(dense_chunk))

    def append_lists(self, transactions, num_items: int | None = None) -> None:
        if num_items is not None and num_items != self.num_items:
            raise ValueError("num_items mismatch")
        self.append_dense(enc.dense_from_lists(transactions, self.num_items))

    # --------------------------------------------------------------- flush --
    def _flush(self) -> None:
        if self._buf_rows == 0:
            return
        shard = self._buf[0] if len(self._buf) == 1 else np.concatenate(self._buf)
        np.save(os.path.join(self.path, shard_filename(len(self._shards))), shard)
        self._shards.append(shard.shape[0])
        self._buf, self._buf_rows = [], 0

    def close(self) -> TransactionStore:
        if self._closed:
            raise RuntimeError("StoreWriter already closed")
        self._flush()
        if self._base is not None:
            # append mode: preserve checkpoint_dir and the count-cache
            # section (the cache self-describes which shard prefix it
            # covers), bump seq, publish atomically
            manifest = dataclasses.replace(
                self._base,
                n=sum(self._shards),
                shard_rows=tuple(self._shards),
                seq=self._base.seq + 1,
            )
        else:
            manifest = StoreManifest(
                version=LAYOUT_VERSION,
                layout=LAYOUT_NAME,
                n=sum(self._shards),
                num_items=self.num_items,
                words=self.words,
                shard_rows=tuple(self._shards),
            )
        _write_manifest(self.path, manifest)
        self._closed = True
        return TransactionStore(self.path, manifest)

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._closed:
            self.close()


# ------------------------------------------------------------------- open ----
def open_store(path: str) -> TransactionStore:
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no transaction store manifest at {manifest_path}")
    with open(manifest_path) as f:
        manifest = StoreManifest.from_json(json.load(f))
    if manifest.version != LAYOUT_VERSION:
        raise ValueError(
            f"store layout version {manifest.version} != supported {LAYOUT_VERSION}"
        )
    if manifest.layout != LAYOUT_NAME:
        raise ValueError(f"unknown store layout {manifest.layout!r}")
    if manifest.words != enc.packed_words(manifest.num_items):
        raise ValueError("manifest words inconsistent with num_items")
    return TransactionStore(path, manifest)


# ----------------------------------------------------------------- ingest ----
def ingest_chunks(chunks, num_items: int, path: str, shard_rows: int = 8192) -> TransactionStore:
    """Ingest any iterator of row chunks — dense {0,1} (rows, num_items) or
    pre-packed uint32 (rows, words); each chunk's dtype/width decides."""
    words = enc.packed_words(num_items)
    with StoreWriter(path, num_items, shard_rows=shard_rows) as w:
        for chunk in chunks:
            chunk = np.asarray(chunk)
            if chunk.dtype == np.uint32 and chunk.shape[1] == words:
                w.append_packed(chunk)
            else:
                w.append_dense(chunk)
    return open_store(path)


def append_chunks(chunks, path: str, shard_rows: int | None = None) -> TransactionStore:
    """Append row chunks (dense or packed, as :func:`ingest_chunks`) to an
    EXISTING store — the continuous-refresh write path (DESIGN.md §15)."""
    w = StoreWriter.open_for_append(path, shard_rows=shard_rows)
    words = w.words
    try:
        for chunk in chunks:
            chunk = np.asarray(chunk)
            if chunk.dtype == np.uint32 and chunk.shape[1] == words:
                w.append_packed(chunk)
            else:
                w.append_dense(chunk)
        return w.close()
    except BaseException:
        # leave the torn append unpublished: old manifest stays authoritative
        w._closed = True
        raise


def ingest_dense(dense: np.ndarray, path: str, shard_rows: int = 8192) -> TransactionStore:
    dense = np.asarray(dense)
    with StoreWriter(path, dense.shape[1], shard_rows=shard_rows) as w:
        w.append_dense(dense)
    return open_store(path)


def ingest_lists(
    transactions, num_items: int, path: str, shard_rows: int = 8192, chunk_rows: int = 8192
) -> TransactionStore:
    with StoreWriter(path, num_items, shard_rows=shard_rows) as w:
        for start in range(0, len(transactions), chunk_rows):
            w.append_lists(transactions[start : start + chunk_rows])
    return open_store(path)


def ingest_quest(qcfg, path: str, shard_rows: int = 8192, chunk_rows: int | None = None) -> TransactionStore:
    """Ingest a synthetic Quest DB via the chunked generator — peak host RAM
    is O(chunk_rows · num_items + num_transactions), never the dense matrix."""
    from repro_torch.data.synthetic import gen_transactions_chunked

    chunk_rows = chunk_rows or shard_rows
    return ingest_chunks(
        gen_transactions_chunked(qcfg, chunk_rows), qcfg.num_items, path, shard_rows=shard_rows
    )
