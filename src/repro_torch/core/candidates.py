"""Level-k candidate generation — the Hadoop *driver* step of the paper.

Classical Apriori join + prune, fully vectorised NumPy (data-dependent shapes
stay on the host, exactly as candidate generation runs on the Hadoop namenode
in the paper).  Frequent itemsets are (F, k) int32 arrays with item ids
ascending within each row and rows in lexicographic order; both invariants are
preserved by construction.
"""

from __future__ import annotations

import numpy as np


def _row_view(a: np.ndarray) -> np.ndarray:
    """View (F, k) rows as a 1-D structured array for set operations."""
    a = np.ascontiguousarray(a)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


def rows_isin(queries: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Row-wise membership: queries (Q, k) in table (T, k) -> bool (Q,)."""
    if table.shape[0] == 0:
        return np.zeros(queries.shape[0], dtype=bool)
    if queries.shape[1] != table.shape[1]:
        raise ValueError("row width mismatch")
    return np.isin(_row_view(queries), _row_view(table))


def generate_candidates(frequent: np.ndarray) -> np.ndarray:
    """F_{k-1} ⋈ F_{k-1} join + downward-closure prune -> candidates (C, k).

    ``frequent``: (F, k-1) lexicographically sorted itemsets. Two itemsets
    sharing their first k-2 items join into a k-candidate; the prune keeps
    only candidates whose every (k-1)-subset is frequent.
    """
    frequent = np.asarray(frequent, dtype=np.int32)
    f, km1 = frequent.shape
    if f < 2:
        return np.zeros((0, km1 + 1), dtype=np.int32)

    # --- join: group rows by their (k-2)-prefix; groups are contiguous. ---
    if km1 == 1:
        group_change = np.zeros(f - 1, dtype=bool)  # single global group
    else:
        prefix = frequent[:, :-1]
        group_change = np.any(prefix[1:] != prefix[:-1], axis=1)
    group_id = np.concatenate([[0], np.cumsum(group_change)])
    sizes = np.bincount(group_id)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    local = np.arange(f) - starts[group_id]

    # each row pairs with the (g - 1 - local) rows after it in its group
    reps = sizes[group_id] - 1 - local
    total = int(reps.sum())
    if total == 0:
        return np.zeros((0, km1 + 1), dtype=np.int32)
    a_idx = np.repeat(np.arange(f), reps)
    seg_start = np.concatenate([[0], np.cumsum(reps)[:-1]])
    b_idx = a_idx + 1 + (np.arange(total) - np.repeat(seg_start, reps))
    candidates = np.concatenate([frequent[a_idx], frequent[b_idx][:, -1:]], axis=1)

    # --- prune: every (k-1)-subset must be frequent. Dropping the last or ---
    # second-to-last column reproduces the two parents (frequent by
    # construction), so only columns 0..k-3 need checking.
    keep = np.ones(candidates.shape[0], dtype=bool)
    for drop in range(km1 - 1):
        sub = np.delete(candidates, drop, axis=1)
        keep &= rows_isin(sub, frequent)
    return candidates[keep]


def all_k_subsets_of_universe(num_items: int, k: int) -> np.ndarray:
    """Paper-faithful naive enumeration (§3.3 'all the subsets'). Exponential —
    only used by the fidelity baseline on small vocabularies."""
    from itertools import combinations

    combos = np.fromiter(
        (i for combo in combinations(range(num_items), k) for i in combo),
        dtype=np.int32,
    )
    return combos.reshape(-1, k)
