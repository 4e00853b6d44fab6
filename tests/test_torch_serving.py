"""PyTorch port: rule extraction, rulebook compile / save / load and batched
recommend on the CPU, held against the JAX package.  Rulebook columns are
byte-equal; recommended items are equal, and scores within rtol=1e-5,
atol=1e-6 (fp32 sums in another order)."""

import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.serving import rulebook as jrb  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.serving import rulebook as trb  # noqa: E402

# each package re-exports a function named ``recommend``, which shadows the module
jrec = importlib.import_module("repro.serving.recommend")
trec = importlib.import_module("repro_torch.serving.recommend")

RTOL, ATOL = 1e-5, 1e-6
COLUMNS = ("ante_packed", "cons_packed", "ante_len", "scores")


@pytest.fixture(scope="module")
def mined():
    """The tests/test_rulebook.py case, mined by both packages."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=40, avg_len=8, seed=3))
    jres = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    tres = tapr.mine(db, tapr.AprioriConfig(min_support=0.04, max_k=4, representation="packed"),
                     device="cpu")
    assert tres.as_dict() == jres.as_dict()
    return db, jres, tres


def _same_columns(a, b):
    for f in COLUMNS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.num_items, a.score_kind, a.min_confidence) == (b.num_items, b.score_kind, b.min_confidence)


# ---------------------------------------------------------------- rules ------
@pytest.mark.parametrize("min_conf", [0.2, 0.4, 0.8])
def test_rule_arrays_byte_equal(mined, min_conf):
    _, jres, tres = mined
    ja = jrules.extract_rule_arrays(jres, min_conf, 40)
    ta = trules.extract_rule_arrays(tres, min_conf, 40)
    for f in ("ante_packed", "cons_packed", "ante_len", "support", "confidence", "lift",
              "count", "ante_count", "cons_count"):
        x, y = getattr(ta, f), getattr(ja, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f

    def rows(rules):
        return [dataclasses.astuple(r) for r in rules]

    assert rows(ta.to_rules()) == rows(ja.to_rules())
    assert rows(trules.extract_rules(tres, min_conf)) == rows(jrules.extract_rules(jres, min_conf))


# ------------------------------------------------------------- rulebook ------
@pytest.mark.parametrize("score,max_rules,pad", [("confidence", None, 64), ("lift", 10, 1),
                                                 ("confidence", 25, 256)])
def test_compile_rulebook_byte_equal(mined, score, max_rules, pad):
    _, jres, tres = mined
    kw = dict(min_confidence=0.4, score=score, max_rules=max_rules, num_items=40, pad_multiple=pad)
    _same_columns(trb.compile_rulebook(tres, **kw), jrb.compile_rulebook(jres, **kw))


def test_save_load_compatible_both_ways(mined, tmp_path):
    _, jres, tres = mined
    jbook = jrb.compile_rulebook(jres, min_confidence=0.4, num_items=40, pad_multiple=64)
    tbook = trb.compile_rulebook(tres, min_confidence=0.4, num_items=40, pad_multiple=64)
    jbook.save(str(tmp_path / "j.npz"))
    tbook.save(str(tmp_path / "t.npz"))
    _same_columns(trb.Rulebook.load(str(tmp_path / "j.npz")), jbook)
    _same_columns(jrb.Rulebook.load(str(tmp_path / "t.npz")), tbook)
    # a placed (device-tensor) rulebook saves the same bytes
    trb.place_rulebook(tbook, "cpu").save(str(tmp_path / "p.npz"))
    _same_columns(jrb.Rulebook.load(str(tmp_path / "p.npz")), jbook)


def test_rulebook_from_arrays(mined):
    _, jres, _ = mined
    jbook = jrb.compile_rulebook(jres, min_confidence=0.4, num_items=40, pad_multiple=64)
    tbook = trb.rulebook_from_arrays(jbook.ante_packed, jbook.cons_packed, jbook.ante_len,
                                     jbook.scores, jbook.num_items, jbook.score_kind,
                                     jbook.min_confidence)
    _same_columns(tbook, jbook)
    assert tbook.num_rules == jbook.num_rules and tbook.num_rows == jbook.num_rows
    with pytest.raises(ValueError):
        trb.rulebook_from_arrays(jbook.ante_packed, jbook.cons_packed[:-1], jbook.ante_len,
                                 jbook.scores, 40)
    with pytest.raises(ValueError):
        trb.rulebook_from_arrays(jbook.ante_packed, jbook.cons_packed, jbook.ante_len,
                                 jbook.scores, 100)


def test_place_rulebook_int32_views(mined):
    _, _, tres = mined
    rb = trb.compile_rulebook(tres, min_confidence=0.4, num_items=40, pad_multiple=64)
    placed = trb.place_rulebook(rb, "cpu")
    assert placed.device.type == "cpu" and rb.device is None
    assert placed.ante_packed.dtype == torch.int32 and placed.scores.dtype == torch.float32
    _same_columns(placed.to_host(), rb)


# ------------------------------------------------------------ recommend ------
def _assert_recs_equal(got, want):
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL)
    # items equal except where two scores sit within the tolerance of each other
    s = want.scores
    close = np.zeros_like(s, dtype=bool)
    gaps = np.abs(np.diff(s, axis=1)) <= ATOL + RTOL * np.abs(s[:, 1:])
    close[:, 1:] |= gaps
    close[:, :-1] |= gaps
    np.testing.assert_array_equal(got.items[~close], want.items[~close])


@pytest.mark.parametrize("top_k,batch", [(5, 32), (4, 8), (10, 1024)])
def test_recommend_matches_jax_on_port_rulebook(mined, top_k, batch):
    db, jres, tres = mined
    jbook = jrb.compile_rulebook(jres, min_confidence=0.4, num_items=40, pad_multiple=64)
    tbook = trb.compile_rulebook(tres, min_confidence=0.4, num_items=40, pad_multiple=64)
    want = jrec.recommend(jbook, db[:60], top_k=top_k, batch_size=batch, impl="jnp")
    got = trec.recommend(tbook, db[:60], top_k=top_k, batch_size=batch, device="cpu")
    assert got.items.dtype == np.int32 and got.scores.dtype == np.float32
    _assert_recs_equal(got, want)
    np.testing.assert_array_equal(got.items, want.items)


def test_recommend_matches_jax_on_carried_rulebook(mined):
    """A rulebook compiled by the JAX package, carried over as numpy arrays."""
    db, jres, _ = mined
    jbook = jrb.compile_rulebook(jres, min_confidence=0.3, score="lift", num_items=40, pad_multiple=32)
    tbook = trb.rulebook_from_arrays(jbook.ante_packed, jbook.cons_packed, jbook.ante_len,
                                     jbook.scores, jbook.num_items, jbook.score_kind)
    want = jrec.recommend(jbook, db[100:190], top_k=6, batch_size=32, impl="jnp")
    got = trec.recommend(trb.place_rulebook(tbook, "cpu"), db[100:190], top_k=6, batch_size=32,
                         device="cpu")
    _assert_recs_equal(got, want)
    py = trec.recommend_python(tbook, db[100:190], top_k=6)
    want_py = jrec.recommend_python(jbook, db[100:190], top_k=6)
    np.testing.assert_array_equal(py.items, want_py.items)
    np.testing.assert_array_equal(py.scores, want_py.scores)


def test_recommend_inputs_and_exclusion(mined):
    db, _, tres = mined
    rb = trb.compile_rulebook(tres, min_confidence=0.4, num_items=40, pad_multiple=64)
    lists = [np.flatnonzero(row).tolist() for row in db[:20]]
    packed = trec.pack_baskets(lists, rb.num_items)
    out_l = trec.recommend(rb, lists, top_k=4, batch_size=8, device="cpu")
    out_p = trec.recommend(rb, packed, top_k=4, batch_size=8, device="cpu")
    out_d = trec.recommend(rb, db[:20], top_k=4, batch_size=8, device="cpu")
    for o in (out_p, out_d):
        np.testing.assert_array_equal(o.items, out_l.items)
        np.testing.assert_array_equal(o.scores, out_l.scores)
    for b in range(20):
        recs = set(out_l.items[b][np.isfinite(out_l.scores[b])].tolist())
        assert not (set(lists[b]) & recs)
    with pytest.raises(ValueError):
        trec.pack_baskets(db[:2, :10], rb.num_items)
    empty = trb.compile_rulebook(tres, min_confidence=1.1, num_items=40, pad_multiple=32)
    assert empty.num_rules == 0
    assert np.all(trec.recommend(empty, db[:8], top_k=3, batch_size=8, device="cpu").scores <= 0)


def test_recommend_matches_python_engine(mined):
    db, _, tres = mined
    rb = trb.compile_rulebook(tres, min_confidence=0.4, num_items=40, pad_multiple=64)
    _assert_recs_equal(trec.recommend(rb, db[:60], top_k=5, batch_size=32, device="cpu"),
                       trec.recommend_python(rb, db[:60], top_k=5))


def test_f1_topk_ties_go_to_lowest_id():
    """F1: on [1,2,2,2,0] with k = 2 the reference (lax.top_k) gives [1,2];
    torch.topk may give [1,3].  The port's _topk_items must give [1,2]."""
    scores = torch.tensor([[1.0, 2.0, 2.0, 2.0, 0.0]])
    idx, vals = trec._topk_items(scores, torch.zeros((1, 1), dtype=torch.int32),
                                 top_k=2, exclude_basket=False, num_items=5)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[2.0, 2.0]]
    jidx, _ = jrec._topk_items(jax.numpy.asarray(scores.numpy()), jax.numpy.zeros((1, 1), jax.numpy.uint32),
                               top_k=2, exclude_basket=False, num_items=5)
    assert np.asarray(jidx).tolist() == idx.tolist()
