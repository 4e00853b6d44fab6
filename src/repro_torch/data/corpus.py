"""LM-corpus adapter: token windows as transactions.

Ties the paper's mining stack to the LM training pipeline: frequent token-set
mining over a corpus ("structured data analysis" in the paper's framing —
co-occurring token sets are the corpus' association structure). Items are the
top-`num_items` most frequent token ids; each window of `window` tokens is one
transaction (the set of items present in it).  A copy of the JAX package's
``data/corpus.py`` (host numpy; byte-equal output).
"""

from __future__ import annotations

import numpy as np


def transactions_from_tokens(tokens: np.ndarray, *, window: int = 64, num_items: int = 512):
    """tokens: 1-D int array -> (dense (N, num_items) int8, item_vocab (num_items,)).

    item_vocab[j] is the original token id of item j.
    """
    tokens = np.asarray(tokens).ravel()
    uniq, counts = np.unique(tokens, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    vocab = uniq[order][:num_items]
    remap = {int(t): j for j, t in enumerate(vocab)}

    n_windows = len(tokens) // window
    dense = np.zeros((n_windows, num_items), dtype=np.int8)
    for w in range(n_windows):
        seg = tokens[w * window : (w + 1) * window]
        for t in seg:
            j = remap.get(int(t))
            if j is not None:
                dense[w, j] = 1
    return dense, vocab
