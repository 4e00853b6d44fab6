"""PyTorch port: the candidate prune by packed int64 keys.

``generate_candidates`` gives rows identical in value, order and dtype to
the JAX package's and to the prune by structured ``rows_isin`` views, on
random levels, on item ids at the top of their bit width and at 0, on one
prefix group, on an empty join, on ids too wide for a key (the fallback)
and on the levels of a Quest mine.  ``mine_prune_rows{level,path}`` counts
every joined row of the levels from 3 up under the path that checked it."""

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import candidates as jcand  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import candidates as cand  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.data import store as st  # noqa: E402
from repro_torch.obs import MiningObs  # noqa: E402


@pytest.fixture(scope="module")
def quest_db():
    return gen_transactions(QuestConfig(num_transactions=3000, num_items=96, avg_len=8, seed=5))


def _level(width, ids, rows, seed):
    """``rows`` distinct sorted ``width``-itemsets over the item ids ``ids``,
    in lexicographic order."""
    rng = np.random.default_rng(seed)
    got = {tuple(sorted(rng.choice(ids, width, replace=False).tolist())) for _ in range(rows)}
    return np.array(sorted(got), dtype=np.int32).reshape(-1, width)


def _structured_prune(frequent):
    """The join, then every (k-1)-subset looked up by structured row views."""
    joined = cand._join(frequent)
    keep = np.ones(joined.shape[0], dtype=bool)
    for drop in range(frequent.shape[1] - 1):
        keep &= cand.rows_isin(np.delete(joined, drop, axis=1), frequent)
    return joined[keep]


def _paths(frequent):
    """``mine_prune_rows`` of one ``generate_candidates`` call, by path."""
    obs = MiningObs()
    cand.generate_candidates(frequent, obs=obs)
    return {k.split('path="')[1][:-2]: v for k, v in obs.counters().items() if k.startswith("mine_prune_rows{")}


def _quest_levels(quest_db):
    res = tapr.mine(quest_db, tapr.AprioriConfig(min_support=0.01, max_k=6, representation="packed"),
                    device="cpu")
    return [res.levels[k][0] for k in sorted(res.levels)]


CASES = {
    **{f"random_w{w}": (lambda w=w: [_level(w, np.arange(14), 300, w)], "keyed" if w > 1 else None)
       for w in range(1, 6)},
    "top_of_width": (lambda: [_level(3, np.array([0, 1, 2, 3, 1020, 1021, 1022, 1023]), 40, 7)], "keyed"),
    "top_of_63_bits": (lambda: [_level(2, np.array([0, 1, 5, (1 << 21) - 2, (1 << 21) - 1]), 12, 8)], "keyed"),
    "past_63_bits": (lambda: [_level(2, np.array([0, 1, 5, (1 << 21) - 1, 1 << 21]), 12, 8)], "rows"),
    "one_prefix_group": (lambda: [np.array([[2, 5, 7], [2, 5, 9], [2, 5, 11], [2, 5, 30]], dtype=np.int32)],
                         "keyed"),
    "empty_join": (lambda: [np.array([[0, 1, 2], [0, 3, 4], [1, 3, 5]], dtype=np.int32)], None),
    "wide_ids": (lambda: [_level(3, np.array([0, 3, 1 << 16, (1 << 16) + 1, (1 << 20) - 1, (1 << 31) - 1]), 20, 9)],
                 "rows"),
    "quest_levels": (None, "keyed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_candidates_identical(case, quest_db):
    """Same rows, order and dtype as the JAX package's ``generate_candidates``
    and as the structured-view prune, through the path the ids call for."""
    make, path = CASES[case]
    levels = _quest_levels(quest_db) if make is None else make()
    assert len(levels) >= (4 if make is None else 1)
    for frequent in levels:
        got = cand.generate_candidates(frequent)
        want = jcand.generate_candidates(frequent)
        assert got.dtype == want.dtype == np.int32 and got.shape[1] == frequent.shape[1] + 1
        assert np.array_equal(got, want) and np.array_equal(got, _structured_prune(frequent))
        joined = cand._join(frequent).shape[0]
        assert _paths(frequent) == ({path: joined} if joined and frequent.shape[1] > 1 else {})


@pytest.mark.parametrize("route", ["memory", "streamed"])
def test_prune_rows_count_every_joined_row_keyed(quest_db, route, tmp_path):
    """On a Quest mine, ``mine_prune_rows{level,path="keyed"}`` equals
    ``mine_candidates_joined{level}`` at every level from 3 up, and no level-2
    key or ``path="rows"`` key is written."""
    cfg = tapr.AprioriConfig(min_support=0.02, max_k=5, representation="packed")
    obs = MiningObs()
    if route == "memory":
        tapr.mine(quest_db, cfg, device="cpu", obs=obs)
    else:
        store = st.ingest_dense(quest_db, str(tmp_path / "db"), shard_rows=800)
        streaming.mine_streamed(store, cfg, device="cpu", chunk_rows=512, obs=obs)
    c = obs.counters()
    joined = {int(k.split('"')[1]): v for k, v in c.items() if k.startswith("mine_candidates_joined{")}
    pruned = {k: v for k, v in c.items() if k.startswith("mine_prune_rows{")}
    assert sum(joined[k] > 0 for k in joined if k >= 3) >= 2
    assert pruned == {f'mine_prune_rows{{level="{k}",path="keyed"}}': v for k, v in joined.items() if k >= 3 and v}
