"""Vectorised IBM Quest generator (Agrawal & Srikant, VLDB 1994).

A frozen copy of the distributions of the port's ``data/synthetic.py``,
drawn with whole-array NumPy calls instead of a Python loop over rows, and
from a stream of its own (the rows differ from ``synthetic.py``'s under the
same seed; their distributions do not):

* item popularity: Zipf weights ``1 / rank**zipf_a`` over ``num_items``;
* a pool of ``num_patterns`` patterns, each of ``max(2, Poisson(I))`` distinct
  items drawn by popularity without replacement;
* per row: ``Poisson(patterns_per_txn)`` patterns drawn with weights
  ``1 / pattern rank``, each item kept with probability ``1 - corruption``;
  then ``max(1, Poisson(T)) - (items so far)`` distinct noise items drawn by
  popularity without replacement from the items the row does not hold yet,
  so that rows average |T| items as Quest's do.  (``synthetic.py`` lets a
  noise item land on a pattern's item, and its rows fall 6-8% short of |T|;
  the copy departs from it there, towards the source.)

Drawing without replacement is done as drawing with replacement and keeping
each row's first distinct draws, which is the same distribution.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK_ROWS = 1 << 14
NOISE_DRAWS = 32   # draws a pass over the rows still short of noise items
NOISE_PASSES = 8   # passes before the rows still short finish by Gumbel keys


@dataclasses.dataclass(frozen=True)
class Quest:
    num_transactions: int
    num_items: int
    avg_len: float            # |T|
    avg_pattern_len: float    # |I|
    num_patterns: int         # |L|
    corruption: float
    patterns_per_txn: float = 1.5
    zipf_a: float = 1.3

    @classmethod
    def from_config(cls, gen: dict) -> "Quest":
        return cls(**{f.name: gen[f.name] for f in dataclasses.fields(cls) if f.name in gen})


def item_weights(q: Quest) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, q.num_items + 1, dtype=np.float64), q.zipf_a)
    return w / w.sum()


def _draw(rng, cdf: np.ndarray, shape) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random(shape), side="right"), cdf.size - 1)


def _distinct(rng, cdf: np.ndarray, need: np.ndarray, num_items: int, held: np.ndarray | None = None) -> np.ndarray:
    """(rows, num_items) bool: row r holds the items of ``held[r]`` and
    ``need[r]`` distinct others, drawn by the weights behind ``cdf`` without
    replacement."""
    rows = need.shape[0]
    got = np.zeros((rows, num_items), dtype=bool) if held is None else held.astype(bool)
    count = np.zeros(rows, dtype=np.int64)
    active = np.flatnonzero(count < need)
    for _ in range(NOISE_PASSES):
        if not active.size:
            return got
        draws = _draw(rng, cdf, (active.size, NOISE_DRAWS))
        for j in range(NOISE_DRAWS):
            item = draws[:, j]
            fresh = ~got[active, item] & (count[active] < need[active])
            got[active[fresh], item[fresh]] = True
            count[active[fresh]] += 1
        active = active[count[active] < need[active]]
    if active.size:
        # the rest of each row's draws, by the same weights over the items it
        # does not hold yet: the largest log(weight) + Gumbel keys
        weights = np.diff(cdf, prepend=0.0)
        keys = np.log(np.maximum(weights, 1e-300)) - np.log(-np.log(rng.random((active.size, num_items))))
        keys[got[active]] = -np.inf
        order = np.argsort(-keys, axis=1, kind="stable")
        take = np.arange(num_items)[None, :] < np.minimum(need[active] - count[active], num_items)[:, None]
        got[np.repeat(active, take.sum(1)), order[take]] = True
    return got


def patterns(q: Quest, rng) -> tuple[np.ndarray, np.ndarray]:
    """The pattern pool: (P, max size) item ids, -1 past each pattern's
    size, and the sizes."""
    sizes = np.minimum(np.maximum(2, rng.poisson(q.avg_pattern_len, q.num_patterns)), q.num_items)
    got = _distinct(rng, np.cumsum(item_weights(q)), sizes, q.num_items)
    table = np.full((q.num_patterns, int(sizes.max())), -1, dtype=np.int64)
    for p, items in enumerate(got):
        ids = np.flatnonzero(items)
        table[p, : ids.size] = ids
    return table, sizes


def transactions(q: Quest, pool: tuple, rng, rows: int) -> np.ndarray:
    """``rows`` transactions of the pattern pool ``pool`` as dense {0,1}
    int8 (rows, num_items), drawn from ``rng``."""
    table, sizes = pool
    cdf = np.cumsum(item_weights(q))
    pat_w = 1.0 / np.arange(1, q.num_patterns + 1, dtype=np.float64)
    pat_cdf = np.cumsum(pat_w / pat_w.sum())
    out = np.zeros((rows, q.num_items), dtype=np.int8)
    for start in range(0, rows, BLOCK_ROWS):
        n = min(BLOCK_ROWS, rows - start)
        block = out[start : start + n]
        n_pat = rng.poisson(q.patterns_per_txn, n)
        length = np.maximum(1, rng.poisson(q.avg_len, n))
        owner = np.repeat(np.arange(n), n_pat)
        chosen = _draw(rng, pat_cdf, owner.size)
        items = table[chosen]                                        # (slots, max size)
        keep = (items >= 0) & (rng.random(items.shape) > q.corruption)
        block[np.broadcast_to(owner[:, None], items.shape)[keep], items[keep]] = 1
        need = np.maximum(0, length - block.sum(1, dtype=np.int64))
        block |= _distinct(rng, cdf, need, q.num_items, held=block).astype(np.int8)
    return out


def generate(q: Quest, data_seed: int, rows: int | None = None, stream: int = 0) -> np.ndarray:
    """The data set of ``q`` under ``data_seed``: the pattern pool from
    ``data_seed`` and ``rows`` (default ``num_transactions``) rows from
    stream ``stream`` of it.  Stream 0 is the data set itself; other streams
    are fresh transactions of the same pool (a shopper's next basket)."""
    pool_rng = np.random.default_rng([data_seed, 0])
    pool = patterns(q, pool_rng)
    rng = np.random.default_rng([data_seed, 1, stream])
    return transactions(q, pool, rng, q.num_transactions if rows is None else rows)
