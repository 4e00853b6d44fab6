"""The plain reference agrees with the program's plain path at a tiny size:
the same frequent itemsets and supports, exactly, and the same answers."""

import numpy as np
import pytest

from bench import checks, common
from bench.data import quest
from bench.reference import mine as ref_mine
from bench.reference import rules as ref_rules

Q = quest.Quest(num_transactions=1200, num_items=40, avg_len=8.0, avg_pattern_len=4.0, num_patterns=30,
                corruption=0.5)


@pytest.fixture(scope="module")
def mined():
    from repro_torch.core.apriori import AprioriConfig, mine

    dense = quest.generate(Q, 4)
    port = mine(dense, AprioriConfig(min_support=0.04, max_k=4, count_impl="ref"), device="cpu")
    return dense, port, ref_mine.frequent_itemsets(dense, 0.04, 4)


def test_itemsets_and_supports_equal_the_programs_plain_mine(mined):
    _, port, ref = mined
    assert len(ref) > 100 and max(len(s) for s in ref) == 4
    assert port.as_dict() == ref
    assert checks.itemsets_differing(port.as_dict(), ref) == 0


def test_rules_equal_the_programs_compiled_rulebook(mined):
    from repro_torch.serving.rulebook import compile_rulebook

    _, port, ref = mined
    book = ref_rules.rules(ref, 0.4, Q.num_items)
    rb = compile_rulebook(port, min_confidence=0.4, num_items=Q.num_items)
    assert len(book["score"]) == rb.num_rules > 50
    assert checks.rules_differing(rb, book) == 0


def test_answers_agree_with_the_programs_plain_recommend(mined):
    from repro_torch.serving.recommend import recommend
    from repro_torch.serving.rulebook import compile_rulebook

    _, port, ref = mined
    book = ref_rules.rules(ref, 0.4, Q.num_items)
    rb = compile_rulebook(port, min_confidence=0.4, num_items=Q.num_items)
    baskets = quest.generate(Q, 4, rows=300, stream=9)
    want = ref_rules.item_scores(book, baskets, Q.num_items).numpy()
    got = recommend(rb, common.pack(baskets), top_k=10, device="cpu", impl="ref")
    score_gap, rank_gap, malformed = checks.answer_gaps(got.items, got.scores, want)
    assert malformed == 0
    assert score_gap < 1e-5 and rank_gap < 1e-5
    ids, vals = ref_rules.top_items(ref_rules.item_scores(book, baskets, Q.num_items), 10)
    agree = (ids == got.items).mean()
    assert agree > 0.98   # the rest are ties within float32 rounding


def test_the_low_precision_control_is_caught(mined):
    dense, _, ref = mined
    low = ref_mine.frequent_itemsets(dense, 0.04, 4, low_precision=True)
    assert checks.itemsets_differing(low, ref) > 0
    book = ref_rules.rules(ref, 0.4, Q.num_items)
    baskets = quest.generate(Q, 4, rows=200, stream=9)
    want = ref_rules.item_scores(book, baskets, Q.num_items).numpy()
    ids, vals = ref_rules.top_items(ref_rules.item_scores(book, baskets, Q.num_items, low_precision=True), 10)
    score_gap, _, _ = checks.answer_gaps(ids, vals.astype(np.float32), want)
    assert score_gap > 1e-3


def test_a_wrong_or_missing_rule_is_counted(mined):
    _, _, ref = mined
    book = ref_rules.rules(ref, 0.4, Q.num_items)

    class Host:
        ante_packed, cons_packed = book["ante"].copy(), book["cons"].copy()
        ante_len, scores = book["ante_len"].copy(), book["score"].copy()

    order = np.argsort(-Host.scores, kind="stable")
    for col in ("ante_packed", "cons_packed", "ante_len", "scores"):
        setattr(Host, col, getattr(Host, col)[order])
    assert checks.rules_differing(Host, book) == 0
    Host.scores = Host.scores.copy()
    Host.scores[-1] = np.nextafter(Host.scores[-1], np.float32(0))
    assert checks.rules_differing(Host, book) == 2
    assert checks.answer_gaps(np.array([[1, 1]]), np.zeros((1, 2), np.float32), np.zeros((1, 40)))[2] == 1
