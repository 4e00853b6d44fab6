"""SON two-phase mining on one device — beyond-paper round-count optimization.

The paper's job structure synchronizes once per level k (max_k Hadoop rounds).
SON (Savasere–Omiecinski–Navathe, VLDB'95) needs exactly TWO rounds
regardless of depth:

  phase 1 (Map):    each partition is mined *locally* to completion at the
                    scaled threshold; the union of local winners is the global
                    candidate set.  No globally frequent itemset can be missed
                    (if s(X)/N >= θ then X is locally frequent in >= 1
                    partition by pigeonhole).
  phase 2 (Reduce): one exact count of the union over the whole DB (the
                    same ``place_db`` + ``_count_level`` path as the
                    level-wise mine), then prune.

Both phases count through the caller's representation: K3 for dense, K1
for packed.  ``winners_to_arrays`` / ``arrays_to_winners`` are the phase-1
union's exchange format, byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import apriori as ap
from repro_torch.device import resolve_device


def _mine_local(t_np: np.ndarray, min_count: int, cfg: ap.AprioriConfig, device) -> dict:
    """Single-partition in-memory Apriori (the phase-1 'mapper').

    Inherits the caller's count/representation config; only the support
    threshold is rescaled to the partition."""
    local_cfg = dataclasses.replace(cfg, min_support=min_count / max(1, t_np.shape[0]))
    return ap.mine(t_np, local_cfg, device=device).levels


def local_winners(partition_dense, cfg: ap.AprioriConfig, device="cuda") -> dict:
    """One partition's phase-1 map output: its locally frequent itemsets at
    the partition-scaled threshold, as ``k -> set of itemset tuples``.  A
    pure function of (partition data, cfg), so re-running a lost mapper
    gives the identical output."""
    part = np.asarray(partition_dense, dtype=np.int8)
    if part.shape[0] == 0:
        return {}
    local_min = max(1, math.ceil(cfg.min_support * part.shape[0]))
    return {
        k: {tuple(int(x) for x in row) for row in sets}
        for k, (sets, _) in _mine_local(part, local_min, cfg, device).items()
    }


def merge_winners(winner_dicts) -> dict:
    """The phase-1 reduce: union per-partition winner dicts per level.
    Order-independent (set union)."""
    union: dict[int, set] = {}
    for w in winner_dicts:
        for k, s in w.items():
            union.setdefault(k, set()).update(s)
    return union


def union_local_winners(partitions, cfg: ap.AprioriConfig, device="cuda") -> dict:
    """The phase-1 mapper over an iterable of dense partitions: mine each
    locally at the partition-scaled threshold and union the winners per
    level.  Partitions are consumed one at a time."""
    return merge_winners(local_winners(part, cfg, device) for part in partitions)


def winners_to_arrays(union: dict) -> dict:
    """Canonicalize a phase-1 union ``k -> set of tuples`` into sorted
    ``k -> (K, k) int32`` candidate arrays.  Sorting makes the layout
    deterministic: the same union always counts byte-identically."""
    return {
        k: np.array(sorted(s), dtype=np.int32).reshape(len(s), k)
        for k, s in sorted(union.items())
        if s
    }


def arrays_to_winners(levels: dict) -> dict:
    """Inverse of :func:`winners_to_arrays` (accepts bare candidate arrays)."""
    return {
        k: {tuple(int(x) for x in row) for row in np.asarray(cands)}
        for k, cands in levels.items()
    }


def mine_son(
    transactions_dense,
    cfg: ap.AprioriConfig = ap.AprioriConfig(),
    *,
    device="cuda",
    num_partitions: int = 8,
) -> ap.AprioriResult:
    """SON over a dense {0,1} transaction matrix on ``device``: phase 1
    mines ``num_partitions`` row ranges locally, phase 2 counts their union
    once over the whole DB."""
    dev = resolve_device(device)
    ap._check_cfg(cfg)
    t_np = np.asarray(transactions_dense, dtype=np.int8)
    n, num_items = t_np.shape
    min_count = max(1, math.ceil(cfg.min_support * n))

    # ---- phase 1: local mining per partition, union of local winners ----
    bounds = np.linspace(0, n, num_partitions + 1).astype(int)
    union = union_local_winners(
        (t_np[bounds[p] : bounds[p + 1]] for p in range(num_partitions)), cfg, dev
    )

    # ---- phase 2: one exact count of the union over the whole DB ----
    count_step = ap.make_count_step(cfg)
    t_dev = ap.place_db(t_np, cfg, dev)
    levels = {}
    for k, cands in winners_to_arrays(union).items():
        sup = ap._count_level(count_step, t_dev, cands, num_items, cfg)
        keep = sup >= min_count
        if keep.any():
            levels[k] = (cands[keep], sup[keep])
    return ap.AprioriResult(levels=levels, num_transactions=n, min_count=min_count)
