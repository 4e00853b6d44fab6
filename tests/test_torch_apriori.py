"""PyTorch port: ``mine`` on the CPU is dict-identical to the JAX package's
packed mine (``count_impl="jnp"``), in both containment modes, in one pass
and in several."""

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


@pytest.fixture(scope="module")
def quest_db():
    return gen_transactions(QuestConfig(num_transactions=3000, num_items=96, avg_len=8, seed=5))


def _both(db, **kw):
    jres = japr.mine(db, japr.AprioriConfig(count_impl="jnp", representation="packed", **kw))
    tres = tapr.mine(db, tapr.AprioriConfig(representation="packed", **kw), device="cpu")
    return jres, tres


@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
@pytest.mark.parametrize("per_pass", [1 << 16, 64])
def test_mine_matches_jax_small_db(small_db, mode, per_pass):
    jres, tres = _both(small_db, min_support=0.05, max_k=4, packed_mode=mode,
                       max_candidates_per_pass=per_pass)
    assert tres.as_dict() == jres.as_dict()
    assert (tres.min_count, tres.num_transactions) == (jres.min_count, jres.num_transactions)
    for k, (sets, sup) in tres.levels.items():
        assert sets.dtype == jres.levels[k][0].dtype and sup.dtype == jres.levels[k][1].dtype


@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
@pytest.mark.parametrize("per_pass", [1 << 16, 64])
def test_mine_matches_jax_quest(quest_db, mode, per_pass):
    jres, tres = _both(quest_db, min_support=0.03, max_k=4, packed_mode=mode,
                       max_candidates_per_pass=per_pass, candidate_pad=32)
    assert tres.total_frequent > 100 and max(tres.levels) >= 3
    assert tres.as_dict() == jres.as_dict()


def test_pipeline_runs_several_passes(small_db, monkeypatch):
    """max_candidates_per_pass=64 splits a level into several counted passes,
    each padded to its bucket with len = -1 rows."""
    calls = []
    real = tops.support_count_packed

    def spy(t, c, ln, **kw):
        calls.append((c.shape[0], int((ln >= 0).sum())))
        return real(t, c, ln, **kw)

    monkeypatch.setattr(tops, "support_count_packed", spy)
    cfg = tapr.AprioriConfig(min_support=0.05, max_k=3, representation="packed",
                             max_candidates_per_pass=64, candidate_pad=32)
    tapr.mine(small_db, cfg, device="cpu")
    assert sum(1 for _, real in calls if real == 64) >= 2   # full passes, then a remainder
    assert all(real <= 64 and kp % 32 == 0 and kp >= real for kp, real in calls)


def test_result_carries_over_from_jax(small_db):
    """An AprioriResult built from the JAX result's levels answers like it."""
    jres = japr.mine(small_db, japr.AprioriConfig(min_support=0.05, max_k=3, count_impl="jnp"))
    tres = tapr.AprioriResult(levels=dict(jres.levels), num_transactions=jres.num_transactions,
                              min_count=jres.min_count)
    assert tres.as_dict() == jres.as_dict() and tres.total_frequent == jres.total_frequent
    some = tuple(int(x) for x in jres.levels[2][0][0])
    assert tres.support(some) == jres.support(some)


def test_level_loop_helpers_match():
    assert [tapr._pad_bucket(k, 256) for k in (0, 1, 256, 257, 70000)] == \
        [japr._pad_bucket(k, 256) for k in (0, 1, 256, 257, 70000)]
    assert tapr._candidate_quantum(tapr.AprioriConfig()) == japr._candidate_quantum(japr.AprioriConfig(), None)
    fields = [f.name for f in __import__("dataclasses").fields(tapr.AprioriConfig)]
    assert fields == [f.name for f in __import__("dataclasses").fields(japr.AprioriConfig)]


def test_count_impl_ref_is_explicit_and_equal(small_db):
    base = dict(min_support=0.05, max_k=3, representation="packed")
    auto = tapr.mine(small_db, tapr.AprioriConfig(**base), device="cpu")
    ref = tapr.mine(small_db, tapr.AprioriConfig(count_impl="ref", **base), device="cpu")
    assert auto.as_dict() == ref.as_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        tapr.mine(small_db, tapr.AprioriConfig(count_impl="kernel", **base), device="cpu")
    with pytest.raises(ValueError):
        tapr.mine(small_db, tapr.AprioriConfig(count_impl="jnp", **base), device="cpu")
    t_dev = tapr.place_db(small_db, tapr.AprioriConfig(**base), device="cpu")
    assert t_dev.dtype == torch.int32 and t_dev.shape == (small_db.shape[0], 1)
    assert np.array_equal(t_dev.numpy().view(np.uint32), japr.enc.pack_bits(small_db))


# ------------------------------------------------------------ observation --
def _observed(db, **kw):
    from repro_torch.obs import MiningObs, Tracer

    obs = MiningObs(tracer=Tracer(sample_rate=1.0))
    res = tapr.mine(db, tapr.AprioriConfig(**kw), device="cpu", obs=obs)
    obs.finish()
    return res, obs


@pytest.mark.parametrize("rep", ["dense", "packed"])
@pytest.mark.parametrize("per_pass", [1 << 16, 64])
def test_mine_with_obs_gives_the_same_itemsets(quest_db, rep, per_pass):
    kw = dict(min_support=0.03, max_k=4, representation=rep, max_candidates_per_pass=per_pass)
    res, obs = _observed(quest_db, **kw)
    plain = tapr.mine(quest_db, tapr.AprioriConfig(**kw), device="cpu")
    assert res.as_dict() == plain.as_dict() and max(res.levels) >= 3
    counters = obs.counters()
    for k, (sets, _) in res.levels.items():
        assert counters[f'mine_frequent{{level="{k}"}}'] == sets.shape[0]
    for p in ("candidate_gen", "cand_place", "count_kernel", "host_sync"):
        assert counters[f'mine_phase_seconds{{phase="{p}"}}'] > 0.0, p


def test_candidate_join_and_prune_lie_within_candidate_gen(quest_db):
    """The join and the prune are timed inside candidate generation: their
    seconds sum to at most its seconds, and each of their spans lies inside
    a ``mine.candidate_gen`` span of the same level."""
    _, obs = _observed(quest_db, min_support=0.03, max_k=4)
    c = obs.counters()
    sec = {p: c[f'mine_phase_seconds{{phase="{p}"}}'] for p in ("candidate_gen", "candidate_join", "candidate_prune")}
    assert 0.0 < sec["candidate_join"] + sec["candidate_prune"] <= sec["candidate_gen"]
    spans = obs.tracer.spans()
    gens = [s for s in spans if s.name == "mine.candidate_gen"]
    inner = [s for s in spans if s.name in ("mine.candidate_join", "mine.candidate_prune")]
    assert inner and {s.name for s in inner} == {"mine.candidate_join", "mine.candidate_prune"}
    for s in inner:
        assert any(g.parent_id == s.parent_id and g.t0 <= s.t0 <= s.t1 <= g.t1 for g in gens), s.name


def test_joined_candidates_are_at_least_the_pruned_ones(quest_db):
    """``mine_candidates_joined{level}`` counts the join's rows before the
    prune: at least ``mine_candidates{level}``, and exactly the join of the
    level below's frequent itemsets."""
    from repro_torch.core import candidates as cand

    res, obs = _observed(quest_db, min_support=0.03, max_k=4)
    c = obs.counters()
    levels = sorted(int(k.split('"')[1]) for k in c if k.startswith("mine_candidates{"))
    assert levels[0] == 1 and len(levels) >= 3
    for k in levels[1:]:
        joined = c[f'mine_candidates_joined{{level="{k}"}}']
        assert joined >= c[f'mine_candidates{{level="{k}"}}']
        assert joined == cand._join(res.levels[k - 1][0]).shape[0]
    assert 'mine_candidates_joined{level="1"}' not in c
