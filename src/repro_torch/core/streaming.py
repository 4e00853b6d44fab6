"""Streaming Map/Reduce mining over an on-disk transaction store.

The paper's jobs never load the DB: each map task streams its HDFS block,
emits partial counts, and a combiner folds them before the reduce.  This
module is that dataflow for the miner on one device (DESIGN.md §9): the DB
lives in a ``data.store.TransactionStore`` (packed uint32 shards on disk),
and each level's count pass iterates fixed-size row chunks through the SAME
count step as the in-memory miner, **accumulating per-candidate partial
counts on the device** — the combiner.  The host syncs a candidate pass
exactly once, after its last chunk (or once per mid-pass checkpoint save).

Chunks are always read from the store as packed words: each crosses to the
card at 4·W bytes a row through ``data.pipeline.ShardedBatchIterator``
(pinned buffers, copies on a side stream overlapping the counting), and
``apriori.place_words`` turns it into the count step's operand there —
unpacked to the dense operand for K3, as it is for K1.  The host never
unpacks a streamed chunk.

Exactness: support counting is integer arithmetic and every chunk row is
either a real transaction or an inert zero row (DESIGN.md §3), so the
chunk-sum equals the whole-DB count bit for bit — ``mine_streamed`` /
``mine_son_streamed`` are dict-equal to ``mine`` / ``mine_son`` (and to the
JAX package's streamed miners) at any chunk size.

Fault tolerance (DESIGN.md §11):

  * ``mine_streamed(checkpoint=..., resume=True)`` persists the miner's
    complete state through :class:`distributed.checkpoint.MiningCheckpoint`
    — completed levels at every level boundary, plus (every
    ``checkpoint_every_chunks`` chunks) the mid-level pass cursor and the
    in-progress accumulator, copied to the host.  Folding the remaining
    chunks into the restored accumulator equals folding all chunks into
    zeros, so a resumed mine is dict-identical to an uninterrupted one.
    The checkpoint format is the JAX package's: either package resumes the
    other's checkpoint.
  * ``mine_son_streamed(fault=FaultConfig(...))`` dispatches phase-1 shard
    partitions through ``distributed.fault_tolerance.run_partitions`` —
    bounded-retry re-execution plus speculative re-issue of stragglers.

On a mesh (``launch.mesh``) every rank streams the same chunks, rounded up
to a multiple of the data-shard count (67 rows become 68 on a 2 x 3 mesh;
the padding rows are inert), and copies only its row block of each; the
candidates split over the model axis as in memory.  Each rank folds its
partial counts into its own accumulator, and the accumulators are reduced
over the mesh once a pass, and before every checkpoint save, so a
checkpoint holds whole counts (integer sums make this identical to reducing
every chunk, as the JAX package does).  SON's phase 1 deals the shards over
the ranks (``son.union_over_mesh``).

``obs`` is an optional mining observer with the JAX package's hooks
(``add_phase``, ``on_chunk``, ``observe_max_candidate_bucket`` and the level
loop's); observation only.
"""

from __future__ import annotations

import math
import time
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.core import apriori as ap
from repro_torch.core import son as son_mod
from repro_torch.core.mapreduce import all_reduce
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.launch.mesh import mesh_device
from repro_torch.obs.mining import device_timer, phase
from repro_torch.distributed.checkpoint import (
    CheckpointMismatch,
    MiningCheckpoint,
    MiningState,
    mining_fingerprint,
    store_fingerprint,
)
from repro_torch.distributed.fault_tolerance import FaultConfig, run_partitions

if TYPE_CHECKING:
    from repro_torch.data.store import TransactionStore


def make_accum_count_step(cfg: ap.AprioriConfig, num_items: int) -> Callable:
    """The combiner: ``(words_chunk, c, lengths, acc) -> acc`` with the
    chunk's counts added into the device-resident int32 accumulator in place.

    ``words_chunk`` is (R, W) int32 word views on the device; the count step
    is :func:`core.apriori.make_count_step`'s (K1 or K3 by representation),
    fed through :func:`core.apriori.place_words`.
    """
    count_step = ap.make_count_step(cfg)

    def step(words, c_dev, len_dev, acc):
        return acc.add_(count_step(ap.place_words(words, num_items, cfg), c_dev, len_dev))

    return step


def _init_acc(kp: int, device, init: np.ndarray | None = None, cfg=None, mesh=None) -> torch.Tensor:
    """A pass's int32 accumulator for a bucket of ``kp`` candidates: on a
    mesh, this rank's block of them over the model axis.  ``init`` (whole
    reduced counts from a checkpoint) seeds the first data shard's block
    only, so the reduce over the data axes counts it once."""
    if mesh is not None:
        m, shards = mesh.shard((cfg.model_axis,)) if cfg.model_axis else (0, 1)
        kp //= shards
        if init is not None:
            init = init[m * kp : (m + 1) * kp] if mesh.shard(cfg.data_axes)[0] == 0 else None
    if init is None:
        return torch.zeros(kp, dtype=torch.int32, device=device)
    return torch.from_numpy(np.array(init, dtype=np.int32)).to(device)


def _reduced(acc: torch.Tensor, cfg, mesh) -> np.ndarray:
    """A pass's whole (Kp,) counts on the host of every rank: this rank's
    partial block summed over the data axes, then assembled over the model
    axis (``apriori.assemble_counts``).  ``acc`` itself is left as it is."""
    if mesh is None:
        return acc.cpu().numpy()
    return ap.assemble_counts(all_reduce(acc.clone(), mesh, tuple(cfg.data_axes)), cfg, mesh)


def _effective_chunk_rows(chunk_rows: int, cfg, mesh) -> int:
    """Round the chunk up to a multiple of the data-shard count so every
    chunk splits evenly over the data axes (padding rows are inert)."""
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be >= 1")
    if mesh is None:
        return chunk_rows
    ap._check_mesh(cfg, mesh)
    shards = mesh.shard(tuple(cfg.data_axes))[1]
    return -(-chunk_rows // shards) * shards


def _packed_chunks(store, chunk_rows: int, start_chunk: int = 0, shards: tuple | None = None):
    """The store's chunks as packed int32 word views, zero-padded to
    ``chunk_rows`` rows (inert), from chunk ``start_chunk`` on."""
    return (
        chunk.view(np.int32)
        for chunk, _ in store.iter_chunks(
            chunk_rows, representation="packed", pad=True, start_chunk=start_chunk, shards=shards
        )
    )


def _observed(it, obs):
    """The chunks of ``it``.  With an observer, the time the fold blocked
    on each chunk it yields is phase ``prefetch_stall`` (the final, empty
    ``next`` is not counted), and the chunk's rows go to ``on_chunk``."""
    t0 = time.perf_counter()
    for chunk in it:
        if obs is not None:
            obs.add_phase("prefetch_stall", t0, time.perf_counter())
            obs.on_chunk(int(chunk.shape[0]))
        yield chunk
        t0 = time.perf_counter()


def _count_pass_chunks(
    accum_step,
    chunks,
    c_dev,
    len_dev,
    kp,
    device,
    prefetch,
    init_acc: np.ndarray | None = None,
    chunks_done: int = 0,
    save_every: int = 0,
    save_fn: Callable | None = None,
    obs=None,
    *,
    cfg,
    mesh=None,
):
    """Fold every DB chunk into a device accumulator; sync ONCE — unless a
    mid-pass checkpoint cadence is set, in which case each save adds exactly
    one extra host sync.

    ``init_acc``/``chunks_done`` restore an interrupted pass: the caller
    skips the already-folded chunks at the store and hands the saved
    accumulator here; the save cadence stays aligned to ABSOLUTE chunk
    indices so a resumed pass checkpoints at the same points.

    ``obs`` attributes the pass's time: ``prefetch_stall`` is the fold
    blocking on the chunk iterator, ``count_kernel`` the device span of
    each chunk's accumulate step (CUDA events, read after the pass's sync:
    the launches and the device's waits for the host between them, so not
    kernel time; host time on the CPU), ``host_sync`` the final device -> host
    copy that also drains the device queue, ``checkpoint_write`` the
    mid-pass saves.  On a mesh ``kp`` is the whole bucket, the fold is
    this rank's, and the result and each save are the reduced counts.
    """
    acc = _init_acc(kp, device, init=init_acc, cfg=cfg, mesh=mesh)
    done = chunks_done
    timer = device_timer(obs, "count_kernel", device)
    it = ShardedBatchIterator(chunks, device, mesh=mesh, data_axes=cfg.data_axes, prefetch=prefetch)
    try:
        for t_chunk in _observed(it, obs):
            with timer:
                accum_step(t_chunk, c_dev, len_dev, acc)
            done += 1
            if save_fn is not None and save_every > 0 and done % save_every == 0:
                with phase(obs, "checkpoint_write"):
                    save_fn(_reduced(acc, cfg, mesh), done)
    finally:
        it.close()
    with phase(obs, "host_sync"):
        out = _reduced(acc, cfg, mesh)   # the final host sync of this candidate pass
    timer.flush()
    return out


def count_supports_streamed(
    store: TransactionStore,
    cand_sets: np.ndarray,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    *,
    device="cuda",
    mesh=None,
    chunk_rows: int = 8192,
    prefetch: int = 2,
    obs=None,
) -> np.ndarray:
    """Exact support counts of ``cand_sets`` over an on-disk store.

    The streamed twin of the in-memory miner's per-level count: candidates
    split into ``max_candidates_per_pass`` passes padded to the same
    buckets; each pass streams all DB chunks through the accumulate step.
    Equals the whole-DB count exactly, for both representations, at any
    ``chunk_rows`` (the final chunk zero-pads, and zero rows are inert).
    """
    dev = mesh_device(device, mesh)
    ap._check_cfg(cfg)
    cand_sets = np.asarray(cand_sets, dtype=np.int32)
    accum_step = make_accum_count_step(cfg, store.num_items)
    return _count_level_streamed(
        accum_step, store, cand_sets, store.num_items, cfg, dev,
        _effective_chunk_rows(chunk_rows, cfg, mesh), prefetch, obs=obs, mesh=mesh,
    )


def _count_level_streamed(
    accum_step,
    store,
    cand_sets,
    num_items,
    cfg,
    device,
    chunk_rows,
    prefetch,
    cursor: MiningState | None = None,
    save_cb: Callable | None = None,
    save_every: int = 0,
    obs=None,
    mesh=None,
):
    """One level's candidate passes over the store.

    ``cursor`` (a mid-level :class:`MiningState`) resumes an interrupted
    level: finished passes' counts are restored verbatim, the in-progress
    pass restarts from its saved accumulator at its saved chunk index, and
    later passes run normally.  ``save_cb(counts, pass_start, acc, done)``
    is invoked every ``save_every`` chunks with the level's cursor state.
    """
    k_total = cand_sets.shape[0]
    quantum = ap._candidate_quantum(cfg, mesh)
    counts = np.zeros(k_total, dtype=np.int64)
    start0, resume_chunks, resume_acc = 0, 0, None
    if cursor is not None:
        if cursor.counts is None or cursor.counts.shape[0] != k_total:
            raise CheckpointMismatch(
                f"mid-level checkpoint carries {None if cursor.counts is None else cursor.counts.shape[0]} "
                f"candidate counts, but level {cursor.next_k} regenerated {k_total} "
                "candidates — checkpoint does not match this mine"
            )
        counts[:] = cursor.counts
        start0 = int(cursor.pass_start)
        resume_chunks = int(cursor.chunks_done)
        resume_acc = cursor.acc
    for start in range(start0, k_total, cfg.max_candidates_per_pass):
        chunk_c = cand_sets[start : start + cfg.max_candidates_per_pass]
        kp = ap._pad_bucket(chunk_c.shape[0], quantum)
        if obs is not None:
            obs.observe_max_candidate_bucket(kp)
        c_dev, len_dev = ap._place_candidates(chunk_c, kp, num_items, cfg, device, mesh)
        init_acc, start_chunk = None, 0
        if resume_acc is not None:   # first pass after a mid-level resume only
            if resume_acc.shape[0] != kp:
                raise CheckpointMismatch(
                    f"saved accumulator has {resume_acc.shape[0]} slots, this pass "
                    f"pads to {kp} — candidate bucketing (candidate_pad / mesh) changed"
                )
            init_acc, start_chunk = resume_acc, resume_chunks
            resume_acc = None
        if save_cb is not None and save_every > 0:
            def save_fn(acc_np, done, _start=start):
                save_cb(counts, _start, acc_np, done)
        else:
            save_fn = None
        out = _count_pass_chunks(
            accum_step, _packed_chunks(store, chunk_rows, start_chunk), c_dev, len_dev, kp,
            device, prefetch, init_acc=init_acc, chunks_done=start_chunk,
            save_every=save_every, save_fn=save_fn, obs=obs, cfg=cfg, mesh=mesh,
        )
        counts[start : start + chunk_c.shape[0]] = out[: chunk_c.shape[0]]
    return counts


def _as_manager(checkpoint, store, mesh=None) -> MiningCheckpoint | None:
    if checkpoint is None or checkpoint is False:
        return None
    if isinstance(checkpoint, MiningCheckpoint):
        return checkpoint.on_mesh(mesh)
    if checkpoint is True:
        return MiningCheckpoint(store.checkpoint_path).on_mesh(mesh)
    return MiningCheckpoint(str(checkpoint)).on_mesh(mesh)


def mine_streamed(
    store: TransactionStore,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    *,
    device="cuda",
    mesh=None,
    chunk_rows: int = 8192,
    prefetch: int = 2,
    checkpoint_cb: Callable | None = None,
    resume_state: dict | None = None,
    checkpoint: "MiningCheckpoint | str | bool | None" = None,
    checkpoint_every_chunks: int = 0,
    resume: bool = False,
    obs=None,
) -> ap.AprioriResult:
    """Level-wise Apriori over an on-disk store on ``device``, dict-equal to
    ``mine``.

    This is ``core.apriori.run_level_loop`` with the count function swapped
    for the chunk-streaming accumulator.  Host RSS scales with
    ``chunk_rows``, not ``store.num_transactions``; the DB is re-streamed
    from disk once per candidate pass.

    Fault tolerance: pass ``checkpoint=True`` (next to the store manifest,
    ``store.checkpoint_path``), a path, or a :class:`MiningCheckpoint` to
    persist the miner's state at every level boundary — plus, when
    ``checkpoint_every_chunks > 0``, mid-level at that chunk cadence.
    ``resume=True`` restores the newest committed snapshot (validated
    against the store and config fingerprints) and continues; the result is
    dict-identical to an uninterrupted mine.  ``checkpoint_cb`` /
    ``resume_state`` remain the raw level-boundary hooks and compose with
    the manager.  On a ``mesh`` rank 0 writes the checkpoints and every rank
    returns the same result.
    """
    dev = mesh_device(device, mesh)
    ap._check_cfg(cfg)
    n, num_items = store.num_transactions, store.num_items
    chunk_rows = _effective_chunk_rows(chunk_rows, cfg, mesh)
    if checkpoint_every_chunks < 0:
        raise ValueError("checkpoint_every_chunks must be >= 0")
    accum_step = make_accum_count_step(cfg, num_items)
    mgr = _as_manager(checkpoint, store, mesh)

    if mgr is None:
        if resume:
            raise ValueError("resume=True requires checkpoint=")

        def count_fn(cand_sets, level_k):
            return _count_level_streamed(
                accum_step, store, cand_sets, num_items, cfg, dev, chunk_rows, prefetch, obs=obs,
                mesh=mesh,
            )

        return ap.run_level_loop(count_fn, n, num_items, cfg, checkpoint_cb, resume_state, obs=obs)

    store_fp = store_fingerprint(store)
    mine_fp = mining_fingerprint(cfg, chunk_rows)

    cursor: MiningState | None = None
    if resume:
        loaded = mgr.load_latest()
        if loaded is not None:
            state, manifest = loaded
            mgr.validate(manifest, store_fp, mine_fp)
            resume_state = {"levels": dict(state.levels), "next_k": state.next_k}
            if state.mid_level:
                cursor = state
    else:
        mgr.clear()   # don't mix snapshots of distinct mines under one seq line

    # completed levels as of NOW — what a mid-level snapshot must carry
    done_levels = {"levels": dict(resume_state["levels"]) if resume_state else {}}

    def level_cb(k, levels):
        done_levels["levels"] = dict(levels)
        mgr.save(MiningState(levels=dict(levels), next_k=k + 1), store_fp, mine_fp)
        if checkpoint_cb:
            checkpoint_cb(k, levels)

    def count_fn(cand_sets, level_k):
        nonlocal cursor
        cur, cursor = cursor, None   # the cursor resumes exactly one level
        if cur is not None and cur.next_k != level_k:
            raise CheckpointMismatch(
                f"mid-level checkpoint is for level {cur.next_k}, "
                f"but the loop resumed at level {level_k}"
            )

        def save_cb(counts, pass_start, acc_np, done):
            mgr.save(
                MiningState(
                    levels=done_levels["levels"],
                    next_k=level_k,
                    mid_level=True,
                    pass_start=pass_start,
                    chunks_done=done,
                    counts=counts,
                    acc=acc_np,
                ),
                store_fp,
                mine_fp,
            )

        return _count_level_streamed(
            accum_step, store, cand_sets, num_items, cfg, dev, chunk_rows, prefetch,
            cursor=cur,
            save_cb=save_cb if checkpoint_every_chunks > 0 else None,
            save_every=checkpoint_every_chunks,
            obs=obs,
            mesh=mesh,
        )

    result = ap.run_level_loop(count_fn, n, num_items, cfg, level_cb, resume_state, obs=obs)
    mgr.wait()   # the last boundary snapshot is committed before we return
    return result


def count_union_streamed(
    store: TransactionStore,
    per_level: dict,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    *,
    device="cuda",
    mesh=None,
    chunk_rows: int = 8192,
    prefetch: int = 2,
    shards: tuple | None = None,
    obs=None,
) -> dict:
    """Exact streamed counts of a multi-level candidate union in ONE pass
    over the store (or over the shard range ``shards=(s0, s1)``).

    ``per_level`` maps ``k -> (K_k, k) int32`` candidate arrays; the return
    maps ``k -> (K_k,) int64`` counts, aligned.  Every level's candidate
    passes are placed on the device up front (the union is the modest
    survivor set, not a full level's candidates), then every DB chunk folds
    into every pass's accumulator: one launch per (chunk, pass).  This is
    SON's phase 2, and the incremental miner's union count.  On a ``mesh``
    every accumulator is reduced once, after the last chunk.
    """
    dev = mesh_device(device, mesh)
    ap._check_cfg(cfg)
    chunk_rows = _effective_chunk_rows(chunk_rows, cfg, mesh)
    num_items = store.num_items
    accum_step = make_accum_count_step(cfg, num_items)
    quantum = ap._candidate_quantum(cfg, mesh)
    per_level = {
        k: np.asarray(cands, dtype=np.int32)
        for k, cands in sorted(per_level.items())
        if np.asarray(cands).shape[0]
    }
    units = []   # (k, start, rows, c_dev, len_dev, acc)
    for k, cands in per_level.items():
        for start in range(0, cands.shape[0], cfg.max_candidates_per_pass):
            chunk_c = cands[start : start + cfg.max_candidates_per_pass]
            kp = ap._pad_bucket(chunk_c.shape[0], quantum)
            if obs is not None:
                obs.observe_max_candidate_bucket(kp)
            c_dev, len_dev = ap._place_candidates(chunk_c, kp, num_items, cfg, dev, mesh)
            units.append((k, start, chunk_c.shape[0], c_dev, len_dev,
                          _init_acc(kp, dev, cfg=cfg, mesh=mesh)))
    timer = device_timer(obs, "count_kernel", dev)
    if units:
        it = ShardedBatchIterator(_packed_chunks(store, chunk_rows, shards=shards), dev,
                                  mesh=mesh, data_axes=cfg.data_axes, prefetch=prefetch)
        try:
            for t_chunk in _observed(it, obs):
                with timer:
                    for _, _, _, c_dev, len_dev, acc in units:
                        accum_step(t_chunk, c_dev, len_dev, acc)
        finally:
            it.close()

    counts = {k: np.zeros(cands.shape[0], dtype=np.int64) for k, cands in per_level.items()}
    with phase(obs, "host_sync"):
        for k, start, rows, _, _, acc in units:
            counts[k][start : start + rows] = _reduced(acc, cfg, mesh)[:rows]
    timer.flush()
    return counts


def mine_son_streamed(
    store: TransactionStore,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    *,
    device="cuda",
    mesh=None,
    chunk_rows: int = 8192,
    prefetch: int = 2,
    fault: FaultConfig | None = None,
    obs=None,
    collect_union: bool = False,
) -> ap.AprioriResult:
    """SON two-phase mining over an on-disk store on ``device``, dict-equal
    to ``mine_son`` (and to ``mine`` — SON is exact for any partitioning).

    Phase 1 maps over the store's *on-disk shards* as the SON partitions:
    each shard is mined locally on ``device`` (``son.local_winners``) to
    completion at the shard-scaled threshold.  With ``fault=FaultConfig(...)``
    the shard mappers run through the retrying work queue
    (:func:`distributed.fault_tolerance.run_partitions`): a failed shard read
    or mapper is re-executed with backoff, stragglers are speculatively
    re-issued, and the executor's :class:`FaultReport` lands on
    ``result.fault_report``.  In ``on_exhausted="skip"`` mode a dropped
    partition is an explicitly reported completeness gap.  With
    ``max_workers > 1`` several mappers mine on the card at once; the
    result does not depend on it.

    Phase 2 is ONE streamed exact count of the union
    (:func:`count_union_streamed`).  ``collect_union=True`` additionally
    attaches the full pre-prune union with its exact counts as
    ``result.union_counts`` (``k -> (cands, counts)``).

    On a ``mesh`` phase 1 deals the shards over the ranks; with ``fault``
    every rank runs the whole executor (as the JAX package's mesh does), so
    every rank holds the same report.
    """
    dev = mesh_device(device, mesh)
    ap._check_cfg(cfg)
    n = store.num_transactions
    min_count = max(1, math.ceil(cfg.min_support * n))
    chunk_rows = _effective_chunk_rows(chunk_rows, cfg, mesh)

    # ---- phase 1: local mining per on-disk shard, union of local winners --
    report = None
    if fault is None and mesh is not None:
        union = son_mod.union_over_mesh(
            lambda p: son_mod.local_winners(store.partition_dense(p), cfg, dev),
            store.num_partitions, mesh,
        )
    elif fault is None:
        union = son_mod.union_local_winners(
            (store.partition_dense(p) for p in range(store.num_partitions)), cfg, dev
        )
    else:
        def map_shard(p: int) -> dict:
            # re-reads shard p from disk on every (re-)execution — idempotent
            return son_mod.local_winners(store.partition_dense(p), cfg, dev)

        winners, report = run_partitions(map_shard, store.num_partitions, fault, obs=obs)
        union = son_mod.merge_winners(w for w in winners if w is not None)

    # ---- phase 2: ONE streamed exact count of the whole union ----
    per_level = son_mod.winners_to_arrays(union)
    counts = count_union_streamed(
        store, per_level, cfg, device=dev, mesh=mesh, chunk_rows=chunk_rows, prefetch=prefetch,
        obs=obs,
    )
    levels = {}
    for k, cands in per_level.items():
        sup = counts[k]
        keep = sup >= min_count
        if keep.any():
            levels[k] = (cands[keep], sup[keep])
    return ap.AprioriResult(
        levels=levels, num_transactions=n, min_count=min_count, fault_report=report,
        union_counts=(
            {k: (cands, counts[k]) for k, cands in per_level.items()}
            if collect_union else None
        ),
    )
