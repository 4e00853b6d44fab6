"""Mining checkpoints: resumable streamed mining as manifest + npz snapshots.

The paper's fault-tolerance story is Hadoop's: a map task that dies is
re-executed from its replicated input split, so a long mine over voluminous
data survives node loss without starting over. This module is that story for
the single-host streaming miner (DESIGN.md §11): ``mine_streamed``
periodically persists its COMPLETE mining state —

  * the frozen frequent-itemset dict (every completed level),
  * the level currently being counted and the candidate-pass cursor,
  * the device count accumulator of the in-progress pass (host snapshot),
  * the chunk cursor into the on-disk store,

— and a resumed mine is dict-identical to an uninterrupted one, because the
store's step-indexed chunk iteration is deterministic and support counting is
integer arithmetic (folding the remaining chunks into the saved accumulator
equals folding all chunks into zeros, bit for bit).

Layout (next to the store manifest by default, see
``TransactionStore.checkpoint_path``)::

    <dir>/ckpt_<SEQ>/{manifest.json, arrays.npz, COMMITTED}

The ``COMMITTED`` marker is written last, so a crash mid-write (including
``kill -9``) leaves an uncommitted directory that :meth:`load_latest`
ignores — restore is crash-consistent. Writes are double-buffered onto a
background thread (:meth:`save` snapshots host arrays synchronously, then
serializes off the miner's critical path); retention keeps the newest
``keep`` committed snapshots.

The manifest additionally records a **store fingerprint** (n, num_items,
shard layout) and the **mining fingerprint** (the result-affecting config
fields plus ``chunk_rows``): resuming against a different store, config or
chunking is an explicit :class:`CheckpointMismatch`, never a silent wrong
answer.

The PyTorch port's copy of the JAX package's checkpoint (numpy only): the
manifest, the npz arrays and :data:`_CONFIG_FIELDS` are the same, so a
checkpoint written by either package's ``mine_streamed`` resumes in the
other.  The port's streamed miner hands :meth:`MiningCheckpoint.save` its device
accumulator as ``acc.cpu().numpy()``.

On a mesh (:meth:`MiningCheckpoint.on_mesh`) one rank writes: every rank
calls ``save`` at the same point of the mine, rank 0 writes and commits the
snapshot, and every rank waits at a barrier until it is committed; every
rank reads on resume.  The miner reduces its accumulator over the mesh
before each save, so a snapshot holds whole counts in the single-device
format, and a checkpoint written on a mesh resumes without one (or in the
JAX package) and the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np

CKPT_VERSION = 1
CKPT_PREFIX = "ckpt_"
COMMITTED = "COMMITTED"

#: AprioriConfig fields that change the mined RESULT or the meaning of the
#: saved cursor state — these must match between the checkpointing mine and
#: the resuming mine. ``max_candidates_per_pass`` and ``candidate_pad`` are
#: cursor-affecting (pass boundaries / accumulator padding), not
#: result-affecting; representation/count_impl are deliberately absent:
#: counting is exact in both representations (DESIGN.md §3/§4).
_CONFIG_FIELDS = (
    "min_support",
    "max_k",
    "use_naive_paper_map",
    "max_candidates_per_pass",
    "candidate_pad",
)


class CheckpointMismatch(ValueError):
    """A checkpoint was written by a different (store, config, chunking)
    than the one trying to resume from it."""


@dataclasses.dataclass
class MiningState:
    """One resumable snapshot of the streamed level loop.

    ``levels`` holds every COMPLETED level (k -> (itemsets, supports)).
    ``next_k`` is the level being (or about to be) counted. A mid-level
    snapshot additionally carries the candidate-pass cursor: ``counts`` are
    the finalized supports of the level's already-finished passes,
    ``pass_start`` the candidate index of the in-progress pass, ``acc`` that
    pass's count accumulator, and ``chunks_done`` how many store chunks have
    been folded into it. ``mid_level`` is False at a clean level boundary
    (the cursor fields are then ignored).
    """

    levels: dict
    next_k: int
    mid_level: bool = False
    pass_start: int = 0
    chunks_done: int = 0
    counts: np.ndarray | None = None    # (k_total,) int64, finished passes
    acc: np.ndarray | None = None       # (kp,) int32, in-progress pass


def store_fingerprint(store, num_shards: int | None = None) -> dict:
    """Identity of the data a checkpoint is valid for.

    By default the fingerprint covers EVERY shard, so appending rows to the
    store invalidates a full-mine checkpoint (its counts covered fewer rows
    than the store now holds — resuming would be silently wrong). The
    incremental path (DESIGN.md §15) passes ``num_shards`` to fingerprint
    only the shard PREFIX its counts actually cover: the same grown store
    then validates against a pre-append fingerprint, because the delta miner
    counts the appended shards separately.
    """
    m = store.manifest
    rows = m.shard_rows if num_shards is None else m.shard_rows[:num_shards]
    return {"n": int(sum(rows)), "num_items": m.num_items, "words": m.words,
            "shard_rows": list(rows)}


def mining_fingerprint(cfg, chunk_rows: int) -> dict:
    """Identity of the mine a checkpoint's cursor state is valid for.
    ``chunk_rows`` is part of it: the chunk cursor counts chunks of exactly
    this size, so a different chunking would misplace the resume point."""
    out = {f: getattr(cfg, f) for f in _CONFIG_FIELDS}
    out["chunk_rows"] = int(chunk_rows)
    return out


class MiningCheckpoint:
    """Manifest+npz checkpoint writer/reader for the streamed miner."""

    def __init__(self, path: str, keep: int = 2):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._seq = self._max_seq(committed_only=False)
        self._mesh = None

    def on_mesh(self, mesh) -> "MiningCheckpoint":
        """Share this manager among the ranks of ``mesh`` (None: this
        process alone): rank 0 writes, every rank waits for each save and
        clear to be committed.  Returns the manager."""
        self._mesh = mesh
        return self

    def _writes(self) -> bool:
        return self._mesh is None or self._mesh.rank == 0

    # -------------------------------------------------------------- write --
    def save(self, state: MiningState, store_fp: dict, mine_fp: dict) -> int:
        """Queue one snapshot for writing; returns its sequence number.

        Host-side array snapshots are taken synchronously (the caller may
        mutate its buffers right after); serialization + fsync-order commit
        happen on a background thread, double-buffered — at most one write
        in flight, :meth:`save` joins the previous one first.  On a mesh the
        snapshot is committed on return, on every rank.
        """
        self.wait()
        self._seq += 1
        seq = self._seq
        if not self._writes():
            self._mesh.barrier()
            return seq
        arrays = {}
        for k, (sets, sup) in state.levels.items():
            arrays[f"sets_{k}"] = np.array(sets, dtype=np.int32, copy=True)
            arrays[f"sup_{k}"] = np.array(sup, dtype=np.int64, copy=True)
        if state.mid_level:
            arrays["counts"] = np.array(state.counts, dtype=np.int64, copy=True)
            arrays["acc"] = np.array(state.acc, dtype=np.int32, copy=True)
        manifest = {
            "version": CKPT_VERSION,
            "seq": seq,
            "next_k": int(state.next_k),
            "mid_level": bool(state.mid_level),
            "pass_start": int(state.pass_start),
            "chunks_done": int(state.chunks_done),
            "levels": sorted(int(k) for k in state.levels),
            "store": store_fp,
            "mining": mine_fp,
        }

        def work():
            self._write(seq, arrays, manifest)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if self._mesh is not None:
            self.wait()
            self._mesh.barrier()
        return seq

    def wait(self) -> None:
        """Join the in-flight background write, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, seq: int, arrays: dict, manifest: dict) -> None:
        out_dir = os.path.join(self.path, f"{CKPT_PREFIX}{seq:08d}")
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # the commit point: everything above is invisible until this exists
        with open(os.path.join(out_dir, COMMITTED), "w") as f:
            f.write("ok")

    def _gc(self) -> None:
        seqs = sorted(self._committed_seqs())
        for s in seqs[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.path, f"{CKPT_PREFIX}{s:08d}"), ignore_errors=True
            )

    # --------------------------------------------------------------- read --
    def _committed_seqs(self):
        if not os.path.isdir(self.path):
            return []
        out = []
        for d in os.listdir(self.path):
            if d.startswith(CKPT_PREFIX) and os.path.exists(
                os.path.join(self.path, d, COMMITTED)
            ):
                out.append(int(d[len(CKPT_PREFIX):]))
        return out

    def _max_seq(self, committed_only: bool = True) -> int:
        if not os.path.isdir(self.path):
            return 0
        seqs = [
            int(d[len(CKPT_PREFIX):])
            for d in os.listdir(self.path)
            if d.startswith(CKPT_PREFIX)
            and (not committed_only or os.path.exists(os.path.join(self.path, d, COMMITTED)))
        ]
        return max(seqs) if seqs else 0

    def latest_seq(self) -> int | None:
        seqs = self._committed_seqs()
        return max(seqs) if seqs else None

    def load_latest(self) -> tuple[MiningState, dict] | None:
        """Newest COMMITTED snapshot as ``(state, manifest)``, or None."""
        seq = self.latest_seq()
        if seq is None:
            return None
        in_dir = os.path.join(self.path, f"{CKPT_PREFIX}{seq:08d}")
        with open(os.path.join(in_dir, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["version"] != CKPT_VERSION:
            raise CheckpointMismatch(
                f"checkpoint version {manifest['version']} != supported {CKPT_VERSION}"
            )
        data = np.load(os.path.join(in_dir, "arrays.npz"))
        levels = {
            int(k): (data[f"sets_{k}"], data[f"sup_{k}"]) for k in manifest["levels"]
        }
        state = MiningState(
            levels=levels,
            next_k=int(manifest["next_k"]),
            mid_level=bool(manifest["mid_level"]),
            pass_start=int(manifest["pass_start"]),
            chunks_done=int(manifest["chunks_done"]),
            counts=data["counts"] if manifest["mid_level"] else None,
            acc=data["acc"] if manifest["mid_level"] else None,
        )
        return state, manifest

    def validate(self, manifest: dict, store_fp: dict, mine_fp: dict) -> None:
        """Refuse to resume across a store/config/chunking change."""
        if manifest["store"] != store_fp:
            raise CheckpointMismatch(
                f"checkpoint was written for store {manifest['store']}, "
                f"resuming against {store_fp}"
            )
        if manifest["mining"] != mine_fp:
            raise CheckpointMismatch(
                f"checkpoint was written with mining fingerprint "
                f"{manifest['mining']}, resuming with {mine_fp}"
            )

    def clear(self) -> None:
        """Drop every snapshot (a completed mine has no use for them)."""
        self.wait()
        if self._writes() and os.path.isdir(self.path):
            for d in os.listdir(self.path):
                if d.startswith(CKPT_PREFIX):
                    shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)
        if self._mesh is not None:
            self._mesh.barrier()
