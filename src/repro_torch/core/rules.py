"""Association-rule extraction from mined frequent itemsets (KDD step 5).

Two implementations of the same contract:

* :func:`extract_rules` — the pure-Python reference: per frequent itemset,
  enumerate every (antecedent, consequent) split and emit :class:`Rule`
  dataclasses.  O(Σ_k F_k · 2^k) Python-loop work; kept as the oracle.
* :func:`extract_rule_arrays` — the production path: splits are enumerated
  as index arrays (one gather per (k, r) split shape), antecedent/consequent
  supports are resolved by :func:`_lookup_supports`, and support /
  confidence / lift are computed as torch float32 ops on the CPU over the
  whole rule set at once, in the JAX package's operation order.  The array
  form (:class:`RuleArrays`) carries packed uint32 bitsets in the word
  layout of the K1 kernel — the input format of the serving rulebook
  compiler (``serving/rulebook.py``, DESIGN.md §8).

Both paths skip splits whose antecedent *or* consequent support is absent
from the mined result (a truncated/partial ``AprioriResult`` — e.g. a
filtered resume checkpoint — would otherwise yield rules with undefined
confidence or ``lift=NaN``), and both sort deterministically:
``(-confidence, -support, antecedent, consequent)``.

The support lookup packs rows into int64 keys as the candidate prune does
(``core/candidates.py``): where every id of the level's table and of the
queries is non-negative and fits in ``b`` bits with ``b * width <= 63``, the
table's keys are sorted once and ``np.searchsorted`` finds each query's.
Wider ids fall back to one ``np.unique`` over the stacked (table ∪ queries)
rows.  Both give the same supports, a repeated table row resolving to its
last support.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import numpy as np
import torch

from repro_torch.core import itemsets as enc
from repro_torch.core.candidates import _pack


@dataclasses.dataclass(frozen=True)
class Rule:
    antecedent: tuple
    consequent: tuple
    support: float      # s(A ∪ C) / N
    confidence: float   # s(A ∪ C) / s(A)
    lift: float         # confidence / (s(C) / N)


def _rule_sort_key(r: Rule):
    return (-r.confidence, -r.support, r.antecedent, r.consequent)


def extract_rules(result, min_confidence: float = 0.5, max_rules: int | None = None):
    """All rules A -> C with A ∪ C frequent and confidence >= threshold.

    Reference implementation (Python loop over all splits). Splits whose
    antecedent or consequent support is missing from ``result`` are skipped
    — never emitted with NaN statistics. Sorted by ``(-confidence,
    -support, antecedent, consequent)`` so ties break deterministically.
    """
    supports = result.as_dict()
    n = result.num_transactions
    rules = []
    for itemset, sup in supports.items():
        if len(itemset) < 2:
            continue
        for r in range(1, len(itemset)):
            for ante in combinations(itemset, r):
                s_a = supports.get(tuple(sorted(ante)))
                if not s_a:
                    continue
                conf = sup / s_a
                if conf < min_confidence:
                    continue
                cons = tuple(sorted(set(itemset) - set(ante)))
                s_c = supports.get(cons)
                if not s_c:
                    continue  # truncated result: lift undefined — skip, not NaN
                lift = conf / (s_c / n)
                rules.append(Rule(tuple(sorted(ante)), cons, sup / n, conf, lift))
    rules.sort(key=_rule_sort_key)
    return rules[:max_rules] if max_rules else rules


# ------------------------------------------------------------------------
# vectorized path
# ------------------------------------------------------------------------

@dataclasses.dataclass
class RuleArrays:
    """Column-oriented rule set — the compile input of the serving rulebook.

    ``ante_packed`` / ``cons_packed`` are uint32 bitsets in the exact word
    layout of the K1 kernel (little-endian bits,
    ``ceil(num_items/32)`` words); ``ante_len`` is the antecedent popcount
    (``-1`` marks padding rows, same sentinel as the counting kernels).
    Score columns are float32, one row per rule, unsorted.
    """

    ante_packed: np.ndarray   # (R, W) uint32
    cons_packed: np.ndarray   # (R, W) uint32
    ante_len: np.ndarray      # (R,)   int32
    support: np.ndarray       # (R,)   float32 — s(A ∪ C) / N
    confidence: np.ndarray    # (R,)   float32
    lift: np.ndarray          # (R,)   float32
    num_items: int
    # exact integer counts (s(A ∪ C), s(A), s(C)) and N: `to_rules` derives
    # its statistics from these in float64 so ordering and values are
    # bit-identical to the Python reference; the float32 columns above are
    # the *serving* payload.
    count: np.ndarray | None = None        # (R,) int64
    ante_count: np.ndarray | None = None   # (R,) int64
    cons_count: np.ndarray | None = None   # (R,) int64
    num_transactions: int = 0

    @property
    def num_rules(self) -> int:
        return int((self.ante_len >= 0).sum())

    def to_rules(self, max_rules: int | None = None) -> list[Rule]:
        """Materialize :class:`Rule` dataclasses, sorted like the reference."""
        keep = self.ante_len >= 0
        ante = enc.unpack_bits(self.ante_packed[keep], self.num_items)
        cons = enc.unpack_bits(self.cons_packed[keep], self.num_items)
        n = self.num_transactions
        rules = [
            Rule(
                tuple(int(i) for i in np.flatnonzero(a)),
                tuple(int(i) for i in np.flatnonzero(c)),
                sup / n, sup / s_a, (sup / s_a) / (s_c / n),
            )
            for a, c, sup, s_a, s_c in zip(
                ante, cons,
                self.count[keep].tolist(), self.ante_count[keep].tolist(),
                self.cons_count[keep].tolist(),
            )
        ]
        rules.sort(key=_rule_sort_key)
        return rules[:max_rules] if max_rules else rules


def _lookup_supports(level, queries: np.ndarray):
    """Vectorized itemset -> support join: for each query row (sorted item
    ids) its mined support, or 0 if absent, and the path that resolved it:
    ``"keyed"`` (sorted int64 keys), ``"rows"`` (one ``np.unique`` over the
    stacked table and query rows), or None where there was no table to
    search.  No per-row Python."""
    q = queries.shape[0]
    if level is None or q == 0:
        return np.zeros(q, dtype=np.int64), None
    table, sup = level
    if table.shape[0] == 0:
        return np.zeros(q, dtype=np.int64), None
    table, queries = np.asarray(table), np.asarray(queries)
    bits = max(1, int(max(table.max(), queries.max())).bit_length())
    if min(table.min(), queries.min()) >= 0 and bits * table.shape[1] <= 63:
        # stable, so the last of a repeated row sits last among its equals
        keys = _pack(table, bits)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        want = _pack(queries, bits)
        at = np.searchsorted(keys, want, side="right") - 1
        found = keys[np.maximum(at, 0)] == want
        return np.where(found, np.asarray(sup, np.int64)[order][at], 0), "keyed"
    stacked = np.concatenate([np.asarray(table, np.int64), np.asarray(queries, np.int64)])
    _, inv = np.unique(stacked, axis=0, return_inverse=True)
    by_uid = np.zeros(int(inv.max()) + 1, dtype=np.int64)
    by_uid[inv[: table.shape[0]]] = np.asarray(sup, np.int64)
    return by_uid[inv[table.shape[0]:]], "rows"


def extract_rule_arrays(
    result,
    min_confidence: float = 0.5,
    num_items: int | None = None,
    obs=None,
) -> RuleArrays:
    """Vectorized rule extraction into :class:`RuleArrays`.

    Per (itemset size k, antecedent size r) the C(k, r) split patterns are a
    single fancy-index gather; supports resolve via :func:`_lookup_supports`;
    the confidence filter runs in float64 (bit-identical selection to the
    Python reference) and the returned score columns are computed as torch
    float32 ops on the CPU over all surviving rules at once.

    ``obs`` (optional mining observer) counts the query rows each lookup
    resolved by its path (``on_rule_lookup_rows``); observation only.
    """
    levels = result.levels
    n = result.num_transactions
    if num_items is None:
        sizes = [int(sets.max()) + 1 for sets, _ in levels.values() if sets.size]
        num_items = max(sizes) if sizes else 1
    w = enc.packed_words(num_items)

    ante_pk, cons_pk, ante_ln = [], [], []
    sup_l, sa_l, sc_l = [], [], []
    for k in sorted(levels):
        sets_k, sup_k = levels[k]
        f = sets_k.shape[0]
        if k < 2 or f == 0:
            continue
        for r in range(1, k):
            patterns = np.array(list(combinations(range(k), r)), dtype=np.int64)  # (P, r)
            p = patterns.shape[0]
            mask = np.ones((p, k), dtype=bool)
            mask[np.arange(p)[:, None], patterns] = False
            comp = np.nonzero(mask)[1].reshape(p, k - r)                          # (P, k-r)
            ante = np.asarray(sets_k)[:, patterns].reshape(f * p, r)
            cons = np.asarray(sets_k)[:, comp].reshape(f * p, k - r)
            s_a, a_path = _lookup_supports(levels.get(r), ante)
            s_c, c_path = _lookup_supports(levels.get(k - r), cons)
            if obs is not None:
                for rows, path in ((ante, a_path), (cons, c_path)):
                    if path is not None:
                        obs.on_rule_lookup_rows(rows.shape[0], path)
            # f64 selection — the same arithmetic the reference performs
            with np.errstate(divide="ignore", invalid="ignore"):
                conf64 = np.asarray(sup_k, np.float64).repeat(p) / s_a
            keep = (s_a > 0) & (s_c > 0) & (conf64 >= min_confidence)
            if not keep.any():
                continue
            ante_pk.append(enc.itemsets_to_packed(ante[keep], num_items))
            cons_pk.append(enc.itemsets_to_packed(cons[keep], num_items))
            ante_ln.append(np.full(int(keep.sum()), r, dtype=np.int32))
            sup_l.append(np.asarray(sup_k, np.int64).repeat(p)[keep])
            sa_l.append(s_a[keep])
            sc_l.append(s_c[keep])

    if not ante_pk:
        z = np.zeros((0, w), np.uint32)
        zf = np.zeros(0, np.float32)
        zi = np.zeros(0, np.int64)
        return RuleArrays(
            z, z.copy(), np.zeros(0, np.int32), zf, zf.copy(), zf.copy(),
            num_items, zi, zi.copy(), zi.copy(), n,
        )

    count = np.concatenate(sup_l)
    ante_count = np.concatenate(sa_l)
    cons_count = np.concatenate(sc_l)
    sup = torch.from_numpy(count).to(torch.float32)
    s_a = torch.from_numpy(ante_count).to(torch.float32)
    s_c = torch.from_numpy(cons_count).to(torch.float32)
    n32 = torch.tensor(n, dtype=torch.float32)
    conf = sup / s_a
    return RuleArrays(
        ante_packed=np.concatenate(ante_pk),
        cons_packed=np.concatenate(cons_pk),
        ante_len=np.concatenate(ante_ln),
        support=(sup / n32).numpy(),
        confidence=conf.numpy(),
        lift=(conf * n32 / s_c).numpy(),
        num_items=num_items,
        count=count,
        ante_count=ante_count,
        cons_count=cons_count,
        num_transactions=n,
    )


def extract_rules_vectorized(
    result,
    min_confidence: float = 0.5,
    max_rules: int | None = None,
    num_items: int | None = None,
) -> list[Rule]:
    """Drop-in vectorized replacement for :func:`extract_rules`."""
    return extract_rule_arrays(result, min_confidence, num_items).to_rules(max_rules)
