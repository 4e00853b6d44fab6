"""Incremental delta mining: fold appended shards into a persisted count
cache instead of re-scanning the whole store (DESIGN.md §15).

The batch Map/Reduce Apriori of the paper re-reads every HDFS block per
refresh. The MapReduce-Apriori survey (PAPERS.md, 1702.06284) catalogs the
incremental family this module implements on top of SON:

  * **Count cache** — after a full SON mine, phase 2 has the EXACT global
    count of every phase-1 union candidate (``mine_son_streamed`` computes
    them all and prunes the sub-threshold ones away). We persist the whole
    pre-prune union with its counts, keyed to the shard prefix it covers,
    as a ``.npz`` sidecar referenced from the store manifest's
    ``count_cache`` section.

  * **Delta mine** — when shards are appended, mine ONLY the new shards as
    fresh SON partitions (phase 1 at the same support fraction θ), then:

      - candidates already in the cache need NO base-store I/O: their grown
        total is ``cached_base_count + delta_count``, exact by additivity of
        integer counts over disjoint row sets. Whether such an itemset
        crosses minsup in either direction is settled by arithmetic alone —
        the "borderline" set costs nothing to re-verify.
      - candidates that are NEW (locally frequent in an appended shard but
        never in the base union) lack a base count; their base support is
        only bounded above by per-partition local-infrequency. These — and
        only these — are re-verified in ONE streamed phase-2 pass over the
        base shards.

    Union completeness is SON's pigeonhole applied to the grown store: a
    globally θ-frequent itemset is locally θ-frequent in ≥ 1 partition, and
    the partitions of the grown store are exactly (base shards ∪ appended
    shards) — the cache holds every base winner, phase 1 here finds every
    appended-shard winner. Exact counts + complete union + same min_count
    ⇒ the delta result is dict-identical to a full re-mine (property-tested
    in ``tests/test_incremental.py``).

  * **Fallback** — when the appended fraction or the level-1 candidate
    drift ("vocabulary drift": new singletons entering the candidate space)
    exceeds a threshold, the incremental pass would approach full-scan cost
    anyway, so we fall back to :func:`build_count_cache` (a full SON
    re-mine that also rewrites the cache).

Crash recovery reuses the :class:`MiningCheckpoint` machinery: the
delta mine snapshots at its two phase boundaries (appended-shard winners;
union delta counts), validated by a fingerprint that pins the grown store
AND the cache generation it folds into — a crash mid-delta resumes without
re-mining the appended partitions, and the cache itself is only rewritten
at the very end via the store's atomic manifest swap, so a crash anywhere
leaves the previous cache authoritative.

On a mesh (``launch.mesh``) the streamed counts run on the mesh, the
appended shards' local mines are dealt over the ranks, and rank 0 alone
writes the count cache and the delta checkpoints; the other ranks wait for
each write and then read the new manifest.
"""

from __future__ import annotations

import dataclasses
import math
import os
import typing

import numpy as np

from repro_torch.core import apriori as ap
from repro_torch.core import son as son_mod
from repro_torch.core import streaming as st

if typing.TYPE_CHECKING:   # runtime import would cycle: data.store -> core
    from repro_torch.data.store import TransactionStore
from repro_torch.distributed.checkpoint import (
    MiningCheckpoint,
    MiningState,
    mining_fingerprint,
    store_fingerprint,
)
from repro_torch.distributed.fault_tolerance import run_partitions
from repro_torch.launch.mesh import mesh_device

CACHE_VERSION = 1

#: delta fraction above which a delta mine degenerates to full-scan cost
DEFAULT_MAX_DELTA_FRACTION = 0.5
#: fraction of level-1 union candidates that are novel (vocabulary drift)
#: above which the borderline re-verify pass stops being "borderline"
DEFAULT_MAX_DRIFT_FRACTION = 0.5

# delta-checkpoint phase markers (stored in MiningState.next_k)
_PHASE_WINNERS = 1      # appended-shard phase-1 winners snapshotted
_PHASE_DELTA_COUNTS = 2  # union counts over the appended shards snapshotted


def cache_filename(seq: int) -> str:
    return f"count_cache_{seq:08d}.npz"


@dataclasses.dataclass
class CountCache:
    """The persisted pre-prune SON union with exact global counts.

    ``store_fp`` fingerprints the shard PREFIX the counts cover (the whole
    store at build time); after appends it still validates against the grown
    store via ``store_fingerprint(store, num_shards)`` — that prefix scoping
    is what lets the delta path accept a store a full-mine checkpoint must
    reject. ``levels`` maps ``k -> (cands (K, k) int32, counts (K,) int64)``.
    """

    seq: int
    min_support: float
    max_k: int
    n: int
    store_fp: dict
    levels: dict
    version: int = CACHE_VERSION

    @property
    def num_shards(self) -> int:
        return len(self.store_fp["shard_rows"])

    def candidate_total(self) -> int:
        return int(sum(c.shape[0] for c, _ in self.levels.values()))

    def winner_sets(self) -> dict:
        return son_mod.arrays_to_winners({k: c for k, (c, _) in self.levels.items()})

    def lookup(self) -> dict:
        """``k -> {itemset tuple -> base count}`` for the fold."""
        return {
            k: {
                tuple(int(x) for x in row): int(cnt)
                for row, cnt in zip(cands, counts)
            }
            for k, (cands, counts) in self.levels.items()
        }


@dataclasses.dataclass
class DeltaReport:
    """What the refresh actually did — surfaced through RefreshController
    metrics and the serve CLI summary."""

    mode: str                 # "delta" | "full" | "noop"
    reason: str               # why this mode was chosen
    base_rows: int
    delta_rows: int
    base_shards: int
    delta_shards: int
    cached_candidates: int = 0
    novel_candidates: int = 0   # re-verified over the base store
    resumed_phase: int = 0      # delta-checkpoint phase restored from


# ------------------------------------------------------------- persistence --
def save_count_cache(store: TransactionStore, cache: CountCache, mesh=None) -> None:
    """Sidecar arrays first, then the atomic manifest swap publishes them —
    torn writes leave the previous cache generation authoritative.  On a
    mesh rank 0 writes; the others wait, then read the new manifest."""
    if mesh is not None:
        if mesh.rank == 0:
            save_count_cache(store, cache)
        mesh.barrier()
        if mesh.rank != 0:
            from repro_torch.data.store import open_store

            store.manifest = open_store(store.path).manifest
        return
    fname = cache_filename(cache.seq)
    final = os.path.join(store.path, fname)
    tmp = final + ".tmp"
    arrays = {}
    for k, (cands, counts) in cache.levels.items():
        arrays[f"sets_{k}"] = np.asarray(cands, dtype=np.int32)
        arrays[f"cnt_{k}"] = np.asarray(counts, dtype=np.int64)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    store.set_count_cache({
        "version": cache.version,
        "seq": cache.seq,
        "file": fname,
        "min_support": cache.min_support,
        "max_k": cache.max_k,
        "n": cache.n,
        "store": cache.store_fp,
        "levels": sorted(int(k) for k in cache.levels),
    })


def load_count_cache(store: TransactionStore) -> CountCache | None:
    """The cache the manifest points at, or None (absent / unreadable /
    future version — all mean "no usable cache", never an exception)."""
    meta = store.count_cache_meta
    if not meta or int(meta.get("version", -1)) != CACHE_VERSION:
        return None
    path = os.path.join(store.path, meta["file"])
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        levels = {
            int(k): (
                np.asarray(data[f"sets_{k}"], dtype=np.int32),
                np.asarray(data[f"cnt_{k}"], dtype=np.int64),
            )
            for k in meta["levels"]
        }
    return CountCache(
        seq=int(meta["seq"]),
        min_support=float(meta["min_support"]),
        max_k=int(meta["max_k"]),
        n=int(meta["n"]),
        store_fp=meta["store"],
        levels=levels,
    )


def build_count_cache(
    store: TransactionStore,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    device="cuda",
    chunk_rows: int = 8192,
    prefetch: int = 2,
    fault=None,
    obs=None,
    *,
    mesh=None,
) -> tuple[ap.AprioriResult, CountCache]:
    """Full SON mine that ALSO persists the pre-prune union counts as the
    count cache — the starting point (and the fallback) of the delta path."""
    res = st.mine_son_streamed(
        store, cfg, device=device, mesh=mesh, chunk_rows=chunk_rows, prefetch=prefetch,
        fault=fault, obs=obs, collect_union=True,
    )
    prev = store.count_cache_meta or {}
    cache = CountCache(
        seq=int(prev.get("seq", 0)) + 1,
        min_support=cfg.min_support,
        max_k=cfg.max_k,
        n=store.num_transactions,
        store_fp=store_fingerprint(store),
        levels=res.union_counts or {},
    )
    save_count_cache(store, cache, mesh)
    return res, cache


# ------------------------------------------------------------------ delta ----
def result_from_cache(cache: CountCache, min_count: int) -> ap.AprioriResult:
    levels = {}
    for k, (cands, counts) in sorted(cache.levels.items()):
        keep = counts >= min_count
        if keep.any():
            levels[k] = (cands[keep], counts[keep])
    return ap.AprioriResult(
        levels=levels, num_transactions=cache.n, min_count=min_count
    )


def cache_invalid_reason(
    store: TransactionStore, cache: CountCache | None, cfg: ap.AprioriConfig
) -> str | None:
    """Why this cache cannot seed a delta mine of this store (None = it can).

    The store check is the prefix fingerprint: the grown store must contain,
    unmodified, exactly the shards the cache counted — appended shards after
    that prefix are what the delta path exists for.
    """
    if cache is None:
        return "no_cache"
    if cache.min_support != cfg.min_support or cache.max_k != cfg.max_k:
        return "config_changed"
    if cache.num_shards > store.num_partitions:
        return "base_mutated"
    if store_fingerprint(store, cache.num_shards) != cache.store_fp:
        return "base_mutated"
    return None


def _delta_manager(checkpoint, store, mesh=None) -> MiningCheckpoint | None:
    if checkpoint is None or checkpoint is False:
        return None
    if isinstance(checkpoint, MiningCheckpoint):
        return checkpoint.on_mesh(mesh)
    if checkpoint is True:
        # separate namespace from full-mine snapshots: the fingerprints
        # differ by construction, but keeping the dirs apart means a delta
        # clear() never deletes a full mine's resume state
        return MiningCheckpoint(os.path.join(store.checkpoint_path, "delta")).on_mesh(mesh)
    return MiningCheckpoint(str(checkpoint)).on_mesh(mesh)


def delta_fingerprints(
    store: TransactionStore, cache: CountCache, cfg: ap.AprioriConfig, chunk_rows: int
) -> tuple[dict, dict]:
    """(store_fp, mine_fp) a delta checkpoint is valid for: the exact grown
    store plus the cache generation whose counts it folds into."""
    mine_fp = mining_fingerprint(cfg, chunk_rows)
    mine_fp["delta_base_shards"] = cache.num_shards
    mine_fp["delta_cache_seq"] = cache.seq
    return store_fingerprint(store), mine_fp


def mine_delta(
    store: TransactionStore,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    device="cuda",
    chunk_rows: int = 8192,
    prefetch: int = 2,
    fault=None,
    checkpoint=None,
    resume: bool = False,
    max_delta_fraction: float = DEFAULT_MAX_DELTA_FRACTION,
    max_drift_fraction: float = DEFAULT_MAX_DRIFT_FRACTION,
    update_cache: bool = True,
    obs=None,
    *,
    mesh=None,
) -> tuple[ap.AprioriResult, DeltaReport]:
    """Mine the grown store incrementally against its persisted count cache.

    Returns ``(result, report)`` where ``result`` is dict-identical to a
    full re-mine of the current store and ``report`` says which path ran
    (delta / full fallback / noop) and why. On success the cache is advanced
    to cover the whole store (``update_cache=False`` skips that, for
    read-only probes). ``checkpoint=True|path|manager`` + ``resume=True``
    give phase-boundary crash recovery via the checkpoint machinery.  On a
    ``mesh`` every rank returns the same result and report.
    """
    dev = mesh_device(device, mesh)
    ap._check_cfg(cfg)
    n_total = store.num_transactions
    min_count = max(1, math.ceil(cfg.min_support * n_total))
    cache = load_count_cache(store)

    def full(reason: str, mgr=None) -> tuple[ap.AprioriResult, DeltaReport]:
        if mgr is not None:
            mgr.clear()
        res, _ = build_count_cache(
            store, cfg, dev, chunk_rows=chunk_rows, prefetch=prefetch,
            fault=fault, obs=obs, mesh=mesh,
        )
        base = cache.n if cache is not None else 0
        return res, DeltaReport(
            mode="full", reason=reason,
            base_rows=base, delta_rows=n_total - base,
            base_shards=cache.num_shards if cache is not None else 0,
            delta_shards=store.num_partitions
            - (cache.num_shards if cache is not None else 0),
        )

    reason = cache_invalid_reason(store, cache, cfg)
    if reason is not None:
        return full(reason)

    base_shards = cache.num_shards
    delta_shards = store.num_partitions - base_shards
    delta_rows = n_total - cache.n
    if delta_shards == 0:
        return (
            result_from_cache(cache, min_count),
            DeltaReport(
                mode="noop", reason="no_new_shards",
                base_rows=cache.n, delta_rows=0,
                base_shards=base_shards, delta_shards=0,
                cached_candidates=cache.candidate_total(),
            ),
        )
    if delta_rows > max_delta_fraction * n_total:
        return full("delta_fraction")

    mgr = _delta_manager(checkpoint, store, mesh)
    store_fp, mine_fp = delta_fingerprints(store, cache, cfg, chunk_rows)
    restored: MiningState | None = None
    if mgr is not None:
        if resume:
            loaded = mgr.load_latest()
            if loaded is not None:
                state, manifest = loaded
                mgr.validate(manifest, store_fp, mine_fp)
                restored = state
        else:
            mgr.clear()

    # ---- phase 1: SON local mining over ONLY the appended shards ----------
    fault_report = None
    if restored is not None:
        new_union = son_mod.arrays_to_winners(
            {k: c for k, (c, _) in restored.levels.items()}
            if restored.next_k == _PHASE_WINNERS
            else {}
        )
    if restored is None:
        if fault is None and mesh is not None:
            new_union = son_mod.union_over_mesh(
                lambda p: son_mod.local_winners(store.partition_dense(base_shards + p), cfg, dev),
                delta_shards, mesh,
            )
        elif fault is None:
            new_union = son_mod.union_local_winners(
                (
                    store.partition_dense(p)
                    for p in range(base_shards, store.num_partitions)
                ),
                cfg, dev,
            )
        else:
            def map_shard(p: int) -> dict:
                return son_mod.local_winners(
                    store.partition_dense(base_shards + p), cfg, dev
                )

            winners, fault_report = run_partitions(
                map_shard, delta_shards, fault, obs=obs
            )
            new_union = son_mod.merge_winners(
                w for w in winners if w is not None
            )
        if mgr is not None:
            winner_arrays = son_mod.winners_to_arrays(new_union)
            mgr.save(
                MiningState(
                    levels={
                        k: (c, np.zeros(c.shape[0], np.int64))
                        for k, c in winner_arrays.items()
                    },
                    next_k=_PHASE_WINNERS,
                ),
                store_fp, mine_fp,
            )
            mgr.wait()

    # ---- split the grown union into cached vs novel candidates ------------
    cached_sets = cache.winner_sets()
    if restored is not None and restored.next_k == _PHASE_DELTA_COUNTS:
        union_sets = son_mod.arrays_to_winners(
            {k: c for k, (c, _) in restored.levels.items()}
        )
        new_union = union_sets  # superset is all we need for the novel split
    novel = {
        k: s - cached_sets.get(k, set()) for k, s in new_union.items()
    }
    novel = {k: s for k, s in novel.items() if s}
    union_sets = {
        k: cached_sets.get(k, set()) | new_union.get(k, set())
        for k in set(cached_sets) | set(new_union)
    }
    union_arrays = son_mod.winners_to_arrays(union_sets)

    # vocabulary drift: novel singletons flooding the candidate space mean
    # the "borderline" re-verify pass is no longer a borderline pass
    u1 = len(union_sets.get(1, set()))
    if u1 and len(novel.get(1, set())) > max_drift_fraction * u1:
        return full("vocabulary_drift", mgr=mgr)

    # ---- delta counts: ONE streamed pass over ONLY the appended shards ----
    if restored is not None and restored.next_k == _PHASE_DELTA_COUNTS:
        delta_counts = {
            k: np.asarray(sup, dtype=np.int64)
            for k, (_, sup) in restored.levels.items()
        }
    else:
        delta_counts = st.count_union_streamed(
            store, union_arrays, cfg, device=dev, mesh=mesh, chunk_rows=chunk_rows,
            prefetch=prefetch, shards=(base_shards, store.num_partitions),
            obs=obs,
        )
        if mgr is not None:
            mgr.save(
                MiningState(
                    levels={
                        k: (union_arrays[k], delta_counts[k])
                        for k in union_arrays
                    },
                    next_k=_PHASE_DELTA_COUNTS,
                ),
                store_fp, mine_fp,
            )
            mgr.wait()

    # ---- borderline re-verify: novel candidates over the BASE shards ------
    novel_arrays = son_mod.winners_to_arrays(novel)
    novel_base = (
        st.count_union_streamed(
            store, novel_arrays, cfg, device=dev, mesh=mesh, chunk_rows=chunk_rows,
            prefetch=prefetch, shards=(0, base_shards), obs=obs,
        )
        if novel_arrays
        else {}
    )
    novel_lookup = {
        k: {
            tuple(int(x) for x in row): int(cnt)
            for row, cnt in zip(novel_arrays[k], novel_base[k])
        }
        for k in novel_arrays
    }

    # ---- fold: total = base + delta, exact by additivity ------------------
    cached_lookup = cache.lookup()
    levels = {}
    new_levels = {}
    for k, cands in union_arrays.items():
        base_counts = np.empty(cands.shape[0], dtype=np.int64)
        ck = cached_lookup.get(k, {})
        nk = novel_lookup.get(k, {})
        for i, row in enumerate(cands):
            key = tuple(int(x) for x in row)
            base_counts[i] = ck[key] if key in ck else nk[key]
        totals = base_counts + delta_counts[k]
        new_levels[k] = (cands, totals)
        keep = totals >= min_count
        if keep.any():
            levels[k] = (cands[keep], totals[keep])

    if update_cache:
        save_count_cache(
            store,
            CountCache(
                seq=cache.seq + 1,
                min_support=cfg.min_support,
                max_k=cfg.max_k,
                n=n_total,
                store_fp=store_fingerprint(store),
                levels=new_levels,
            ),
            mesh,
        )
    if mgr is not None:
        mgr.clear()

    result = ap.AprioriResult(
        levels=levels, num_transactions=n_total, min_count=min_count,
        fault_report=fault_report,
    )
    report = DeltaReport(
        mode="delta", reason="ok",
        base_rows=cache.n, delta_rows=delta_rows,
        base_shards=base_shards, delta_shards=delta_shards,
        cached_candidates=cache.candidate_total(),
        novel_candidates=int(
            sum(c.shape[0] for c in novel_arrays.values())
        ),
        resumed_phase=restored.next_k if restored is not None else 0,
    )
    return result, report
