"""Level-k candidate generation — the Hadoop *driver* step of the paper.

Classical Apriori join + prune, fully vectorised NumPy (data-dependent shapes
stay on the host, exactly as candidate generation runs on the Hadoop namenode
in the paper).  Frequent itemsets are (F, k) int32 arrays with item ids
ascending within each row and rows in lexicographic order; both invariants are
preserved by construction.

The prune looks each candidate's (k-1)-subsets up among the frequent rows by
packed keys: where every item id is non-negative and fits in ``b`` bits with
``b * k <= 63``, a row packs into one int64 (first column most significant,
so keys order as rows do), each subset's key is the candidate's with one
field cut out by shifts and masks, and ``np.searchsorted`` finds it among the
sorted frequent keys.  Wider ids or deeper levels fall back to ``rows_isin``
over structured row views.  Both give the same rows in the same order.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.mining import phase


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


def lex_sort_rows(a: np.ndarray) -> np.ndarray:
    """Sort rows lexicographically (first column most significant)."""
    if a.shape[0] == 0:
        return a
    order = np.lexsort(a.T[::-1])
    return a[order]


def generate_candidates(frequent: np.ndarray, obs=None) -> np.ndarray:
    """F_{k-1} ⋈ F_{k-1} join + downward-closure prune -> candidates (C, k).

    ``frequent``: (F, k-1) lexicographically sorted itemsets. Two itemsets
    sharing their first k-2 items join into a k-candidate; the prune keeps
    only candidates whose every (k-1)-subset is frequent.

    ``obs`` (optional mining observer) times the ``candidate_join`` and
    ``candidate_prune`` phases, counts the joined rows
    (``on_candidates_joined``) and, where a row has subsets to check, the
    rows entering the prune by its path (``on_prune_rows``); observation
    only.
    """
    frequent = np.asarray(frequent, dtype=np.int32)
    f, km1 = frequent.shape
    if f < 2:
        return np.zeros((0, km1 + 1), dtype=np.int32)
    with phase(obs, "candidate_join"):
        candidates = _join(frequent)
    if obs is not None:
        obs.on_candidates_joined(km1 + 1, candidates.shape[0])
    if candidates.shape[0] == 0:
        return candidates
    with phase(obs, "candidate_prune"):
        pruned, path = _prune(candidates, frequent)
    if obs is not None and path is not None:
        obs.on_prune_rows(km1 + 1, candidates.shape[0], path)
    return pruned


def _join(frequent: np.ndarray) -> np.ndarray:
    """Every pair of rows sharing their first k-2 items, as a k-row."""
    f, km1 = frequent.shape
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
    return np.concatenate([frequent[a_idx], frequent[b_idx][:, -1:]], axis=1)


def _prune(candidates: np.ndarray, frequent: np.ndarray):
    """Every (k-1)-subset must be frequent. Dropping the last or
    second-to-last column reproduces the two parents (frequent by
    construction), so only columns 0..k-3 need checking.  Returns the kept
    rows and the path that checked them: ``"keyed"``, ``"rows"``, or None
    where there was nothing to check (k = 2)."""
    km1 = frequent.shape[1]
    if km1 < 2:
        return candidates, None
    bits = _key_bits(frequent)
    if bits is None:
        keep = np.ones(candidates.shape[0], dtype=bool)
        for drop in range(km1 - 1):
            sub = np.delete(candidates, drop, axis=1)
            keep &= rows_isin(sub, frequent)
        return candidates[keep], "rows"
    table = np.sort(_pack(frequent, bits))
    keys = _pack(candidates, bits)
    keep = np.ones(candidates.shape[0], dtype=bool)
    for drop in range(km1 - 1):
        low = bits * (km1 - drop)  # bits of the columns after ``drop``
        sub = ((keys >> (low + bits)) << low) | (keys & ((1 << low) - 1))
        at = np.minimum(np.searchsorted(table, sub), table.shape[0] - 1)
        keep &= table[at] == sub
    return candidates[keep], "keyed"


def _key_bits(frequent: np.ndarray):
    """Bits an item takes in a packed key, or None where ids are negative or
    a row of the next level (one column wider) would not fit in 63 bits.
    Every candidate's ids are frequent rows' ids, so these bound both."""
    bits = max(1, int(frequent.max()).bit_length())
    return bits if frequent.min() >= 0 and bits * (frequent.shape[1] + 1) <= 63 else None


def _pack(rows: np.ndarray, bits: int) -> np.ndarray:
    """(R, w) rows -> (R,) int64 keys, first column most significant."""
    keys = np.zeros(rows.shape[0], dtype=np.int64)
    for j in range(rows.shape[1]):
        keys = (keys << bits) | rows[:, j].astype(np.int64)
    return keys


def all_k_subsets_of_universe(num_items: int, k: int) -> np.ndarray:
    """Paper-faithful naive enumeration (§3.3 'all the subsets'). Exponential —
    only used by the fidelity baseline on small vocabularies."""
    from itertools import combinations

    combos = np.fromiter(
        (i for combo in combinations(range(num_items), k) for i in combo),
        dtype=np.int32,
    )
    return combos.reshape(-1, k)
