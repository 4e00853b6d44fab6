"""Plain level-wise Apriori over a DB held in blocks: the reference of a data
set too large to count in one piece.

The level loop of ``reference.mine``, with its ``candidates`` and its
``count`` (float32 {0,1} products, TF32 off, int64 sums): each level's
candidates are counted block by block and the blocks' supports summed in
int64.  A candidate holds only the items of its level's candidates, so each
block is counted over those columns alone.  The blocks stay on ``device``
as int8 for the whole loop.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import mine as ref_mine


def frequent_itemsets(blocks: list, min_support: float, max_k: int, device="cpu",
                      low_precision: bool = False) -> dict:
    """``{itemset tuple: support}`` of every frequent itemset of at most
    ``max_k`` items in the DB that ``blocks`` (dense {0,1} int8 arrays of
    one width) make up, as ``reference.mine.frequent_itemsets`` of their
    concatenation gives it.

    ``low_precision`` is the control: each block's supports summed into
    bfloat16 and the blocks' into a bfloat16 total, which has to come out
    wrong."""
    n = sum(b.shape[0] for b in blocks)
    num_items = blocks[0].shape[1]
    min_count = max(1, int(np.ceil(min_support * n)))
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    held = [torch.from_numpy(np.ascontiguousarray(b, dtype=np.int8)).to(device) for b in blocks]
    out: dict = {}
    frequent: list = []
    for k in range(1, max_k + 1):
        cands = ref_mine.candidates(frequent, k, list(range(num_items)))
        if not cands:
            break
        cols = sorted({i for c in cands for i in c})
        at = {item: j for j, item in enumerate(cols)}
        local = [tuple(at[i] for i in c) for c in cands]
        index = torch.tensor(cols, dtype=torch.int64, device=device)
        total = torch.zeros(len(cands), dtype=torch.bfloat16 if low_precision else torch.int64)
        for t in held:
            part = ref_mine.count(t.index_select(1, index).to(torch.float32), local, low_precision)
            total += torch.from_numpy(part).to(total.dtype)
        sup = total.to(torch.int64).numpy()
        frequent = [c for c, s in zip(cands, sup) if s >= min_count]
        if not frequent:
            break
        out.update((c, int(s)) for c, s in zip(cands, sup) if s >= min_count)
    del held
    return out
