"""K2's ordered contract on the CPU: ``ref.rule_match_ordered`` (the plain
version of what the CUDA kernel returns bit for bit) against the JAX
package's oracle and its Pallas kernel in interpret mode (within rtol=1e-5,
atol=1e-6: the JAX sums run in another order), against a numpy float32
oracle that adds each matched rule's score in ascending rule order (bit for
bit), and across batch splits (bit for bit)."""

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.itemsets import pack_bits, packed_words  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rule_match import rule_match_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from test_rule_match import RULE_SHAPES, random_rule_problem  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CHUNK = 1024  # rules per staged chunk in csrc/rule_match.cu

# (B, I, R): W = 1, 9, 10 and 32 words; R past one kernel chunk and not a
# multiple of it in the last two
COVER_SHAPES = [(64, 20, 40), (64, 280, 300), (64, 300, CHUNK + 6), (64, 1000, 1500)]


def _words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _ordered(bk, ante, lengths, cons, scores) -> np.ndarray:
    return tref.rule_match_ordered(_words(bk), _words(ante), torch.from_numpy(lengths), _words(cons),
                                   torch.from_numpy(scores)).numpy()


def _padded_problem(b, i, r, seed):
    """random_rule_problem with zero padding rows, plus rows with len = -1
    that still hold antecedent and consequent bits and a score, and every
    5th basket zero."""
    bk, ante, lengths, cons, scores = random_rule_problem(b, i, r, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ghost = rng.choice(np.flatnonzero(lengths >= 0), max(1, r // 10), replace=False)
    lengths[ghost] = -1
    bk[::5] = 0
    return bk, ante, lengths, cons, scores


def _numpy_oracle(bk, ante, lengths, cons, scores, num_words):
    """out[b, i] = +0, then out[b, i] += s_r in float32 for each matched rule
    r with bit i in its consequent, r ascending."""
    matched = ((bk[:, None, :] & ante[None]) == ante[None]).all(-1) & (lengths >= 0)[None, :]
    cons_bits = np.unpackbits(cons.view(np.uint8), axis=1, bitorder="little").astype(bool)
    out = np.zeros((bk.shape[0], 32 * num_words), np.float32)
    for r in range(ante.shape[0]):
        rows = np.flatnonzero(matched[:, r])
        if rows.size:
            out[np.ix_(rows, np.flatnonzero(cons_bits[r]))] += np.float32(scores[r])
    return out


@pytest.mark.parametrize("shape", RULE_SHAPES)
def test_ordered_matches_jax(shape):
    """Within tolerance of the JAX oracle and of the Pallas kernel (interpret
    mode) on the operands padded to its blocks."""
    b, i, r = shape
    prob = random_rule_problem(b, i, r, seed=sum(shape))
    bk, ante, lengths, cons, scores = prob
    got = _ordered(*prob)
    want = np.asarray(jref.rule_match_ref(*[jnp.asarray(x) for x in prob]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    bn, bkk = 32, 128
    pb, pr = -b % bn, -r % bkk
    pal = np.asarray(rule_match_pallas(
        jnp.asarray(np.pad(bk, ((0, pb), (0, 0)))), jnp.asarray(np.pad(ante, ((0, pr), (0, 0)))),
        jnp.asarray(np.pad(lengths, (0, pr), constant_values=-1)), jnp.asarray(np.pad(cons, ((0, pr), (0, 0)))),
        jnp.asarray(np.pad(scores, (0, pr))), block_n=bn, block_k=bkk, interpret=True))[:b]
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", RULE_SHAPES + COVER_SHAPES)
def test_ordered_bit_equal_to_numpy_oracle(shape):
    """Bit for bit the ascending-r float32 sum, with len = -1 rows that hold
    bits and zero baskets in the batch."""
    b, i, r = shape
    prob = _padded_problem(b, i, r, seed=sum(shape))
    got = _ordered(*prob)
    want = _numpy_oracle(*prob, num_words=packed_words(i))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got[::5], 0.0)


@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_ordered_rows_independent_of_batch(shape):
    """The rows of one batch of 64 equal those of 4 batches of 16 and of 64
    batches of 1, bit for bit."""
    b, i, r = shape
    bk, *rules = _padded_problem(b, i, r, seed=sum(shape) + 7)
    whole = _ordered(bk, *rules)
    for size in (16, 1):
        parts = np.concatenate([_ordered(bk[s : s + size], *rules) for s in range(0, b, size)])
        np.testing.assert_array_equal(parts.view(np.uint32), whole.view(np.uint32))


@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_ordered_all_match_batch(shape):
    """Baskets holding every item match every rule with len >= 0: bit-equal
    to the oracle, every row the same, within tolerance of the JAX oracle."""
    b, i, r = shape
    _, ante, lengths, cons, scores = _padded_problem(b, i, r, seed=sum(shape) + 3)
    bk = pack_bits(np.ones((16, i), np.int8))
    got = _ordered(bk, ante, lengths, cons, scores)
    want = _numpy_oracle(bk, ante, lengths, cons, scores, num_words=packed_words(i))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, np.broadcast_to(got[:1], got.shape))
    jax_out = np.asarray(jref.rule_match_ref(*[jnp.asarray(x) for x in (bk, ante, lengths, cons, scores)]))
    np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)


def test_ordered_empty_and_all_padding():
    """No rules, or only len = -1 rules holding bits, score zero everywhere."""
    bk, ante, lengths, cons, scores = random_rule_problem(12, 70, 9, seed=4, pad_frac=0)
    w = packed_words(70)
    none = _ordered(bk, ante[:0], lengths[:0], cons[:0], scores[:0])
    assert none.shape == (12, 32 * w)
    np.testing.assert_array_equal(none, 0.0)
    dead = _ordered(bk, ante, np.full_like(lengths, -1), cons, scores)
    np.testing.assert_array_equal(dead, 0.0)


def _wide_problem(i, r, seed):
    """8 baskets over i items and r rules: a third of the antecedents drawn
    from a basket's own items (so they match), where i allows with one item
    past 65,535; consequents of 1 to 3 items, every 4th with one past
    65,535; every 9th rule with 5 to 8 antecedent and consequent items;
    every 10th len = -1 with its bits and score kept."""
    from repro.core.itemsets import itemsets_to_packed

    rng = np.random.default_rng(seed)
    dense = (rng.random((8, i)) < 0.3).astype(np.int8)

    def pick(pool, m, far):
        items = rng.choice(pool, size=m, replace=False)
        if far and (pool >= 65_536).any():
            items[0] = rng.choice(pool[pool >= 65_536])
        return itemsets_to_packed(np.unique(items)[None], i)[0]

    ante, cons = [], []
    for row in range(r):
        wide = row % 9 == 0
        pool = np.flatnonzero(dense[row % 8]) if row % 3 == 0 else np.arange(i)
        ante.append(pick(pool, rng.integers(5, 9) if wide else rng.integers(1, 5), row % 6 == 0))
        cons.append(pick(np.arange(i), rng.integers(5, 9) if wide else rng.integers(1, 4), row % 4 == 0))
    ante, cons = np.stack(ante), np.stack(cons)
    lengths = np.unpackbits(ante.view(np.uint8), axis=1).sum(1).astype(np.int32)
    lengths[::10] = -1
    return pack_bits(dense), ante, lengths, cons, rng.random(r).astype(np.float32)


@pytest.mark.parametrize("i", [42_528, 70_000])
def test_ordered_wide_rulebooks(i):
    """F4's widths, 1,329 and 2,188 words (the second with item ids past
    65,535 in antecedents and consequents): within tolerance of the JAX
    oracle and bit for bit the ascending-r numpy oracle."""
    prob = _wide_problem(i, 300, seed=i)
    bk, ante, lengths, cons, scores = prob
    got = _ordered(*prob)
    assert got.shape == (8, 32 * packed_words(i))
    want = np.asarray(jref.rule_match_ref(*[jnp.asarray(x) for x in prob]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.view(np.uint32), _numpy_oracle(*prob, num_words=packed_words(i)).view(np.uint32))
    if i > 65_536:
        assert got[:, 65_536:].any()  # matched rules fan out to items past 65,535
        matched = ((bk[:, None, :] & ante[None]) == ante[None]).all(-1).any(0) & (lengths >= 0)
        assert (matched & ante[:, 2048:].any(1)).any()  # and antecedents holding one match
