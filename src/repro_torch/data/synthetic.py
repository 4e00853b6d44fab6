"""IBM Quest-style synthetic transaction generator (the T10I4D family used by
the Apriori literature, incl. the datasets the paper's testbed mimics).

Transactions are built from a pool of 'potentially frequent' patterns: each
transaction draws a few patterns (sizes ~ Poisson(pattern_len)), keeps each
pattern item with prob (1 - corruption), and tops up with zipf-weighted noise
items until ~Poisson(avg_len) items. Deterministic under seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuestConfig:
    num_transactions: int = 10_000
    num_items: int = 512
    avg_len: float = 10.0          # T in T10I4D
    num_patterns: int = 64
    avg_pattern_len: float = 4.0   # I in T10I4D
    corruption: float = 0.35
    patterns_per_txn: float = 1.5
    zipf_a: float = 1.3            # item popularity skew for noise items
    seed: int = 0


def gen_transactions_chunked(cfg: QuestConfig = QuestConfig(), chunk_rows: int = 8192):
    """Yield the rows of :func:`gen_transactions` as dense {0,1} int8 chunks
    of at most ``chunk_rows`` rows — the SAME rows, in the SAME order, under
    the SAME seed (``gen_transactions`` is literally the concatenation of
    this generator), so huge synthetic DBs can be ingested into an on-disk
    store (``data.store.ingest_quest``) without materializing the (n, i)
    matrix. Peak memory is O(chunk_rows · num_items) for the chunk buffer
    plus O(n) for the per-transaction Poisson draws, which must be drawn
    up-front in one call each to preserve the rng stream.
    """
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be >= 1")
    rng = np.random.default_rng(cfg.seed)
    n, i = cfg.num_transactions, cfg.num_items

    # item popularity (zipf-ish, normalized)
    weights = 1.0 / np.power(np.arange(1, i + 1, dtype=np.float64), cfg.zipf_a)
    weights /= weights.sum()

    # pattern pool
    patterns = []
    for _ in range(cfg.num_patterns):
        size = max(2, rng.poisson(cfg.avg_pattern_len))
        size = min(size, i)
        patterns.append(rng.choice(i, size=size, replace=False, p=weights))

    n_pat = rng.poisson(cfg.patterns_per_txn, size=n)
    txn_len = np.maximum(1, rng.poisson(cfg.avg_len, size=n))
    pat_weights = 1.0 / np.arange(1, cfg.num_patterns + 1, dtype=np.float64)
    pat_weights /= pat_weights.sum()
    for start in range(0, n, chunk_rows):
        rows = min(chunk_rows, n - start)
        out = np.zeros((rows, i), dtype=np.int8)
        for r in range(rows):
            t = start + r
            for _ in range(n_pat[t]):
                pat = patterns[rng.choice(cfg.num_patterns, p=pat_weights)]
                keep = rng.random(pat.size) > cfg.corruption
                out[r, pat[keep]] = 1
            deficit = txn_len[t] - int(out[r].sum())
            if deficit > 0:
                noise = rng.choice(i, size=min(deficit, i), replace=False, p=weights)
                out[r, noise] = 1
        yield out


def gen_transactions(cfg: QuestConfig = QuestConfig()) -> np.ndarray:
    """Returns dense {0,1} int8 (num_transactions, num_items)."""
    chunks = list(gen_transactions_chunked(cfg, chunk_rows=max(1, cfg.num_transactions)))
    if not chunks:
        return np.zeros((0, cfg.num_items), dtype=np.int8)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


def gen_transaction_lists(cfg: QuestConfig = QuestConfig()) -> list:
    dense = gen_transactions(cfg)
    return [np.flatnonzero(row).tolist() for row in dense]
