"""Plain association rules and recommendations.

A rule A -> C is every split of a frequent itemset into a non-empty
antecedent A and consequent C with ``s(A u C) / s(A) >= min_confidence``
(compared in float64); its score is the confidence in float32, ``s(A u C)``
over ``s(A)`` each rounded to float32 first.  A basket's recommendation
sums, for every item, the scores of the rules whose antecedent the basket
holds and whose consequent holds the item, masks the basket's own items,
and takes the ``top_k`` items by descending sum, lower item id first.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

RULE_BLOCK = 1 << 15


def _bitsets(itemsets: list, num_items: int) -> np.ndarray:
    """Item-id tuples -> (R, ceil(I/32)) uint32, item i at bit i % 32 of
    word i // 32."""
    out = np.zeros((len(itemsets), (num_items + 31) // 32), dtype=np.uint32)
    rows = np.repeat(np.arange(len(itemsets)), [len(s) for s in itemsets])
    items = np.fromiter((i for s in itemsets for i in s), dtype=np.int64, count=rows.size)
    np.bitwise_or.at(out, (rows, items // 32), (np.uint32(1) << (items % 32).astype(np.uint32)))
    return out


def rules(supports: dict, min_confidence: float, num_items: int) -> dict:
    """Every rule of the frequent itemsets ``supports`` as columns:
    ``ante``, ``cons`` (R, W) uint32, ``ante_len`` (R,) int32, ``score`` (R,)
    float32, ``ante_items`` and ``cons_items`` (lists of tuples)."""
    ante_items, cons_items, sups, ante_sups = [], [], [], []
    for itemset, sup in supports.items():
        if len(itemset) < 2:
            continue
        for r in range(1, len(itemset)):
            for ante in combinations(itemset, r):
                s_a = supports[ante]
                if sup / s_a < min_confidence:
                    continue
                ante_items.append(ante)
                cons_items.append(tuple(i for i in itemset if i not in ante))
                sups.append(sup)
                ante_sups.append(s_a)
    score = np.array(sups, dtype=np.float32) / np.array(ante_sups, dtype=np.float32)
    return dict(
        ante=_bitsets(ante_items, num_items), cons=_bitsets(cons_items, num_items),
        ante_len=np.array([len(a) for a in ante_items], dtype=np.int32),
        score=score.astype(np.float32), ante_items=ante_items, cons_items=cons_items,
    )


def _dense(itemsets: list, num_items: int, dtype, device) -> torch.Tensor:
    out = torch.zeros((len(itemsets), num_items), dtype=dtype)
    rows = torch.arange(len(itemsets)).repeat_interleave(torch.tensor([len(s) for s in itemsets]))
    out[rows, torch.tensor([i for s in itemsets for i in s], dtype=torch.int64)] = 1
    return out.to(device)


def item_scores(book: dict, baskets: np.ndarray, num_items: int, device="cpu",
                low_precision: bool = False) -> torch.Tensor:
    """(S, I) float64 evidence of each item for each dense {0,1} basket
    (S, I), the basket's own items at -inf.  ``low_precision`` rounds the
    scores to bfloat16 and sums them in bfloat16: the control."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b = torch.from_numpy(np.ascontiguousarray(baskets, dtype=np.int8)).to(device)
    bf = b.to(torch.float32)
    acc_dtype = torch.bfloat16 if low_precision else torch.float64
    acc = torch.zeros(b.shape, dtype=acc_dtype, device=device)
    n = len(book["ante_items"])
    for start in range(0, n, RULE_BLOCK):
        stop = min(n, start + RULE_BLOCK)
        ante = _dense(book["ante_items"][start:stop], num_items, torch.float32, device)
        lens = torch.from_numpy(book["ante_len"][start:stop]).to(device).to(torch.float32)
        hit = (bf @ ante.T) == lens
        score = torch.from_numpy(book["score"][start:stop]).to(device).to(acc_dtype)
        cons = _dense(book["cons_items"][start:stop], num_items, acc_dtype, device)
        acc += (hit.to(acc_dtype) * score) @ cons
    acc = acc.to(torch.float64)
    return acc.masked_fill(b > 0, float("-inf"))


def top_items(scores: torch.Tensor, top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """(S, top_k) item ids and their sums: descending, lower id first."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return idx[:, :top_k].cpu().numpy(), vals[:, :top_k].cpu().numpy()
