"""Plain level-wise Apriori: frequent itemsets and their exact supports.

Candidates: every item, then every pair of frequent items, then the join of
two frequent (k-1)-itemsets that share their first k-2 items, kept only if
every (k-1)-subset is frequent.  Supports: the DB as a float32 {0,1}
matrix, a candidate contained in a row where the row's product with the
candidate's indicator equals its size, counted in int64 over the rows.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

CANDIDATE_BLOCK = 8192


def _indicator(cands: list, num_items: int, device) -> torch.Tensor:
    rows = torch.arange(len(cands)).repeat_interleave(len(cands[0]))
    cols = torch.tensor([i for c in cands for i in c], dtype=torch.int64)
    out = torch.zeros((len(cands), num_items), dtype=torch.float32)
    out[rows, cols] = 1.0
    return out.to(device)


def count(db: torch.Tensor, cands: list, low_precision: bool = False) -> np.ndarray:
    """Supports of ``cands`` (tuples of item ids) over ``db`` (N, I) float32.

    ``low_precision`` sums each candidate's hits over the rows into a
    bfloat16 result: the control, which has to come out wrong."""
    out = np.zeros(len(cands), dtype=np.int64)
    for start in range(0, len(cands), CANDIDATE_BLOCK):
        block = cands[start : start + CANDIDATE_BLOCK]
        hits = (db @ _indicator(block, db.shape[1], db.device).T) == float(len(block[0]))
        if low_precision:
            sums = hits.to(torch.bfloat16).sum(0, dtype=torch.bfloat16).to(torch.int64)
        else:
            sums = hits.sum(0, dtype=torch.int64)
        out[start : start + len(block)] = sums.cpu().numpy()
    return out


def candidates(frequent: list, k: int, items: list) -> list:
    """Level-k candidates from the sorted frequent (k-1)-itemsets."""
    if k == 1:
        return [(i,) for i in items]
    if k == 2:
        return list(combinations(sorted(f[0] for f in frequent), 2))
    known = set(frequent)
    by_prefix: dict = {}
    for f in frequent:
        by_prefix.setdefault(f[:-1], []).append(f[-1])
    out = []
    for prefix, lasts in by_prefix.items():
        lasts.sort()
        for a, b in combinations(lasts, 2):
            cand = prefix + (a, b)
            if all(cand[:j] + cand[j + 1 :] in known for j in range(k - 2)):
                out.append(cand)
    out.sort()
    return out


def frequent_itemsets(dense: np.ndarray, min_support: float, max_k: int, device="cpu",
                      low_precision: bool = False) -> dict:
    """``{itemset tuple: support}`` of every frequent itemset of at most
    ``max_k`` items in the dense {0,1} DB, ``min_count = ceil(min_support
    * N)`` computed in float64 as the configuration states it."""
    n, num_items = dense.shape
    min_count = max(1, int(np.ceil(min_support * n)))
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    db = torch.from_numpy(np.ascontiguousarray(dense, dtype=np.int8)).to(device).to(torch.float32)
    out: dict = {}
    frequent: list = []
    for k in range(1, max_k + 1):
        cands = candidates(frequent, k, list(range(num_items)))
        if not cands:
            break
        sup = count(db, cands, low_precision)
        frequent = [c for c, s in zip(cands, sup) if s >= min_count]
        if not frequent:
            break
        out.update((c, int(s)) for c, s in zip(cands, sup) if s >= min_count)
    del db
    return out
