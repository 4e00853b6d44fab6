"""PyTorch port: rule extraction's support lookup by packed int64 keys.

``extract_rule_arrays`` gives the JAX package's nine ``RuleArrays`` columns
byte for byte, and the same ``to_rules()`` rows, on a Quest mine at 1,000
items, on item ids at the top of their bit width, on both sides of the
63-bit edge (where the ``np.unique`` fallback takes the widest lookups), on
truncated results whose lookups miss, on an empty and a missing level, and
on a table with a repeated row.  ``_lookup_supports`` resolves every query
as the JAX package's ``np.unique`` join does, through the path the ids call
for.  ``mine_rule_lookup_rows{path}`` counts every query row of a compile."""

import dataclasses
from itertools import combinations
from math import comb

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.data import store as st  # noqa: E402
from repro_torch.obs import MiningObs  # noqa: E402
from repro_torch.serving.rulebook import compile_rulebook  # noqa: E402

COLUMNS = ("ante_packed", "cons_packed", "ante_len", "support", "confidence", "lift",
           "count", "ante_count", "cons_count")


@pytest.fixture(scope="module")
def quest_db():
    return gen_transactions(QuestConfig(num_transactions=2000, num_items=1000, avg_len=10, num_patterns=200,
                                        seed=11))


def _closed_levels(ids, width, sets, seed):
    """The downward closure of ``sets`` random ``width``-itemsets over the
    item ids ``ids``: every level 1..width, rows sorted, random supports."""
    rng = np.random.default_rng(seed)
    tops = {tuple(sorted(rng.choice(ids, width, replace=False).tolist())) for _ in range(sets)}
    levels = {}
    for k in range(1, width + 1):
        rows = sorted({sub for t in tops for sub in combinations(t, k)})
        levels[k] = (np.array(rows, dtype=np.int32).reshape(-1, k),
                     rng.integers(1, 200, len(rows)).astype(np.int64))
    return levels


def _drop_rows(levels, k, keep):
    sets, sup = levels[k]
    levels[k] = (sets[keep], sup[keep])
    return levels


def _truncated(seed):
    """Rows of levels 1–3 missing, so antecedents and consequents are absent."""
    levels = _closed_levels(np.arange(40), 4, 12, seed)
    rng = np.random.default_rng(seed)
    for k in (1, 2, 3):
        _drop_rows(levels, k, rng.random(levels[k][0].shape[0]) > 0.3)
    return levels


def _over_table_max():
    """Levels 1 and 2 hold ids up to 7 alone: the level-2 to level-4 rows'
    subsets, with ids up to 1,023, are queried in tables whose largest id
    is 7 (keys of the table's 3 bits would alias them)."""
    levels = _closed_levels(np.array([0, 1, 2, 5, 7, 900, 1000, 1023]), 4, 6, 3)
    for k in (1, 2):
        _drop_rows(levels, k, levels[k][0].max(axis=1) <= 7)
    return levels


def _repeated_row():
    """Level 2 repeats a row under another support."""
    levels = _closed_levels(np.arange(12), 3, 5, 4)
    sets, sup = levels[2]
    levels[2] = (np.insert(sets, 2, sets[1], axis=0), np.insert(sup, 2, sup[1] + 77))
    return levels


def _empty_level():
    levels = _closed_levels(np.arange(20), 4, 6, 5)
    levels[2] = (np.zeros((0, 2), np.int32), np.zeros(0, np.int64))
    return levels


def _missing_level():
    levels = _closed_levels(np.arange(20), 4, 6, 6)
    del levels[1]
    return levels


# levels (None: the Quest mine), num_items, and the paths the lookups take;
# an 8-itemset's width-7 lookups pack 7 · 9 = 63 bits with ids below 512
# and 70 bits (the fallback) once an id is 512
CASES = {
    "quest_1000": (None, 1000, {"keyed"}),
    "top_of_width": (lambda: _closed_levels(np.array([0, 1, 2, 3, 1020, 1021, 1022, 1023]), 4, 8, 1), 1024,
                     {"keyed"}),
    "at_63_bits": (lambda: _closed_levels(np.array([0, 1, 2, 3, 4, 505, 506, 507, 508, 509, 510, 511]), 8, 3, 2),
                   512, {"keyed"}),
    "past_63_bits": (lambda: _closed_levels(np.array([0, 1, 2, 3, 4, 506, 507, 508, 509, 510, 511, 512]), 8, 3, 2),
                     513, {"keyed", "rows"}),
    "over_table_max": (_over_table_max, 1024, {"keyed"}),
    "truncated": (lambda: _truncated(7), 40, {"keyed"}),
    "empty_level": (_empty_level, 20, {"keyed"}),
    "missing_level": (_missing_level, 20, {"keyed"}),
    "repeated_row": (_repeated_row, 12, {"keyed"}),
}


def _results(case, quest_db):
    make, num_items, paths = CASES[case]
    if make is None:
        tres = tapr.mine(quest_db, tapr.AprioriConfig(min_support=0.008, max_k=5, representation="dense"),
                         device="cpu")
        levels, n = tres.levels, tres.num_transactions
        assert len(levels) == 5 and max(int(s.max()) for s, _ in levels.values()) > 511
    else:
        levels, n = make(), 200
    return (tapr.AprioriResult(levels, n, 1), japr.AprioriResult(levels, n, 1), num_items, paths)


def _lookup_paths(obs):
    return {k.split('path="')[1][:-2]: v for k, v in obs.counters().items()
            if k.startswith("mine_rule_lookup_rows{")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_arrays_byte_equal_to_jax(case, quest_db):
    """All nine columns byte-equal to the JAX package's ``extract_rule_arrays``
    (its ``np.unique`` join), the same ``to_rules()`` rows, and the rows of
    the Python reference; the lookups take the paths the ids call for."""
    tres, jres, num_items, paths = _results(case, quest_db)
    for min_conf in (0.0, 0.4):
        obs = MiningObs()
        got = trules.extract_rule_arrays(tres, min_conf, num_items, obs=obs)
        want = jrules.extract_rule_arrays(jres, min_conf, num_items)
        for f in COLUMNS:
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), (f, min_conf)
        assert got.num_rules > 0 and set(_lookup_paths(obs)) == paths

        def rows(rules):
            return [dataclasses.astuple(r) for r in rules]

        assert rows(got.to_rules()) == rows(want.to_rules())
        if case != "repeated_row":   # the reference's dict keeps one support a row
            assert rows(got.to_rules()) == rows(trules.extract_rules(tres, min_conf))


def _table(width, ids, rows, seed):
    rng = np.random.default_rng(seed)
    got = {tuple(sorted(rng.choice(ids, width, replace=False).tolist())) for _ in range(rows)}
    return np.array(sorted(got), dtype=np.int32).reshape(-1, width)


# width, the table's ids, the extra ids only queries hold, and the path
LOOKUPS = {
    "w1_top_of_int32": (1, [0, 5, (1 << 31) - 1], [], "keyed"),
    "w2_top_of_int32": (2, [0, 3, 9, (1 << 31) - 2, (1 << 31) - 1], [], "keyed"),
    "w3_at_63_bits": (3, [0, 1, 4, (1 << 21) - 2, (1 << 21) - 1], [], "keyed"),
    "w3_past_63_bits": (3, [0, 1, 4, (1 << 21) - 1, 1 << 21], [], "rows"),
    "w3_queries_past_63_bits": (3, [0, 1, 4, 7, 9, 11], [1 << 21], "rows"),
    "w3_queries_past_table_max": (3, [0, 1, 4, 7, 9, 11], [12, 1000], "keyed"),
    "w9_at_63_bits": (9, [0, 1, 2, 3, 4, 5, 120, 125, 126, 127], [], "keyed"),
    "w9_past_63_bits": (9, [0, 1, 2, 3, 4, 5, 120, 125, 126, 128], [], "rows"),
    "negative_ids": (2, [-3, 0, 1, 4, 7], [], "rows"),
}


@pytest.mark.parametrize("case", sorted(LOOKUPS))
def test_lookup_supports_paths_and_values(case):
    """Every query's support (0 where absent, a repeated table row's last)
    equals the JAX package's ``np.unique`` join and a dict's; the path is the
    keyed one exactly where every id is non-negative and fits ``b`` bits
    with ``b * width <= 63``."""
    width, ids, extra, path = LOOKUPS[case]
    ids = np.array(ids, dtype=np.int64)
    full = _table(width, ids, 40, 1)
    table = np.concatenate([full[::2], full[:1]])   # every other row, the first repeated
    sup = np.arange(1, table.shape[0] + 1, dtype=np.int64) * 3
    queries = np.concatenate([full[::-1], _table(width, np.concatenate([ids, extra]), 60, 2)])
    got, got_path = trules._lookup_supports((table, sup), queries)
    want = jrules._lookup_supports((table, sup), queries)
    by_row = dict(zip(map(tuple, table.tolist()), sup.tolist()))   # the last of a repeated row
    assert got_path == path
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    assert got.tolist() == [by_row.get(tuple(q), 0) for q in queries.tolist()]
    assert (got == 0).any() and (got > 0).any()


def test_lookup_supports_without_a_table():
    queries = np.array([[0, 1], [2, 3]], dtype=np.int32)
    for level in (None, (np.zeros((0, 2), np.int32), np.zeros(0, np.int64))):
        got, path = trules._lookup_supports(level, queries)
        assert path is None and got.dtype == np.int64 and got.tolist() == [0, 0]
    got, path = trules._lookup_supports((queries, np.array([4, 5])), queries[:0])
    assert path is None and got.shape == (0,)


@pytest.mark.parametrize("route", ["memory", "streamed"])
def test_rule_lookup_rows_count_every_query_keyed(quest_db, route, tmp_path):
    """A Quest mine's compile resolves 2 · F_k · C(k, r) query rows for every
    (k, r) split, all keyed: ``mine_rule_lookup_rows{path="keyed"}`` holds
    their sum and no ``path="rows"`` key is written."""
    cfg = tapr.AprioriConfig(min_support=0.008, max_k=4, representation="packed")
    db = quest_db[:1200, :256]
    if route == "memory":
        res = tapr.mine(db, cfg, device="cpu")
    else:
        store = st.ingest_dense(db, str(tmp_path / "db"), shard_rows=400)
        res = streaming.mine_streamed(store, cfg, device="cpu", chunk_rows=256)
    assert len(res.levels) == 4
    obs = MiningObs()
    compile_rulebook(res, min_confidence=0.3, num_items=256, obs=obs)
    want = sum(2 * s.shape[0] * comb(k, r) for k, (s, _) in res.levels.items() for r in range(1, k))
    assert _lookup_paths(obs) == {"keyed": want}
