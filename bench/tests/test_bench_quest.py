"""The vectorised Quest generator: deterministic under its seed, with rows
of |T| items, and with the pattern sizes and item skew of the program's own
generator."""

import dataclasses

import numpy as np
import pytest

from bench.data import quest


def _q(t, i, n=4000):
    return quest.Quest(num_transactions=n, num_items=400, avg_len=float(t), avg_pattern_len=float(i),
                       num_patterns=300, corruption=0.5)


def test_same_seed_same_rows_other_seed_other_rows():
    q = _q(10, 4, 2000)
    a, b, c = quest.generate(q, 7), quest.generate(q, 7), quest.generate(q, 8)
    assert a.dtype == np.int8 and a.shape == (2000, 400)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # a stream of its own: fresh rows of the same pool, also deterministic
    s1, s2 = quest.generate(q, 7, rows=300, stream=5), quest.generate(q, 7, rows=300, stream=5)
    assert np.array_equal(s1, s2) and not np.array_equal(s1, a[:300])


@pytest.mark.parametrize("t,i", [(10, 4), (40, 10)])
def test_row_length_and_pattern_size_match_the_programs_generator(t, i):
    from repro_torch.data.synthetic import QuestConfig, gen_transactions

    q = _q(t, i)
    mine = quest.generate(q, 3)
    theirs = gen_transactions(QuestConfig(num_transactions=q.num_transactions, num_items=q.num_items,
                                          avg_len=q.avg_len, num_patterns=q.num_patterns,
                                          avg_pattern_len=q.avg_pattern_len, corruption=q.corruption, seed=3))
    # |T| itself, as Quest's rows: noise tops a row up with items it does not
    # hold yet.  The program's generator lets noise land on a pattern's item
    # and falls short of |T|; the copy departs from it there.
    assert abs(mine.sum(1).mean() - t) < 0.02 * t
    assert theirs.sum(1).mean() < mine.sum(1).mean()
    # max(2, Poisson(|I|)) items a pattern, over a pool large enough to read its mean
    _, sizes = quest.patterns(dataclasses.replace(q, num_patterns=4000), np.random.default_rng(11))
    assert abs(sizes.mean() - i) < 0.25
    assert sizes.min() >= 2
    # the same popularity skew: the ten most frequent items hold a like share
    top = lambda d: np.sort(d.mean(0))[::-1][:10].sum() / d.mean(0).sum()  # noqa: E731
    assert abs(top(mine) - top(theirs)) < 0.05
