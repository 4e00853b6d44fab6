"""K1's item-major bitmaps on the CPU: ``ref.item_bitmaps`` (the plain
transpose) and ``ref.support_count_bitmaps`` (the plain bitmap count, what
the CUDA kernel computes) held exactly against the JAX package's oracle
(and_cmp) and its Pallas kernel in interpret mode (both modes), on the
sweep and on K1's edges: N not a multiple of 32 and N = 1, empty candidates
with len 0 and 3, len = -1 rows that keep their bits, candidates of 1, 4, 9
and 40 items, and popcount lengths below and above the item count."""

import sys

import pytest
from conftest import REPO_ROOT

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.itemsets import pack_bits  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.support_count_packed import support_count_packed_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import random_problem  # noqa: E402
from test_kernels import SHAPES  # noqa: E402

sys.path.insert(0, REPO_ROOT)
from chip_smoke import k1_edge_problem  # noqa: E402

MODES = ["and_cmp", "popcount"]


def _words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _bitmap_counts(tp, cp, lengths, mode):
    t = _words(tp)
    return tref.support_count_bitmaps(tref.item_bitmaps(t), _words(cp), torch.from_numpy(lengths),
                                      tp.shape[0], mode).numpy()


def _pallas(tp, cp, lengths, mode):
    """The Pallas kernel in interpret mode, one block over the whole
    operands, so that no zero row is padded in (one would count for an
    empty candidate)."""
    n, w = tp.shape
    k = cp.shape[0]
    return np.asarray(support_count_packed_pallas(
        jnp.asarray(tp), jnp.asarray(cp), jnp.asarray(lengths), block_n=n, block_k=k, block_w=w,
        mode=mode, interpret=True))


def _check(tp, cp, lengths, mode):
    got = _bitmap_counts(tp, cp, lengths, mode)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _pallas(tp, cp, lengths, mode))
    if mode == "and_cmp":
        want = np.asarray(jref.support_count_packed_ref(jnp.asarray(tp), jnp.asarray(cp), jnp.asarray(lengths)))
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_item_bitmaps_layout(n):
    """Bit r of word j of item i is item i of row 32·j + r; bits past N are 0."""
    rng = np.random.default_rng(n)
    dense = (rng.random((n, 70)) < 0.4).astype(np.int8)
    got = tref.item_bitmaps(_words(pack_bits(dense))).numpy().view(np.uint32)
    nb = -(-n // 32)
    assert got.shape == (96, nb)
    rows = np.zeros((32 * nb, 96), np.int64)
    rows[:n, :70] = dense
    want = (rows.reshape(nb, 32, 96) << np.arange(32)[None, :, None]).sum(1).T.astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_bitmap_count_matches_jax(shape, mode):
    """The sweep of tests/test_kernels.py, with len = -1 padding rows."""
    n, i, k = shape
    t, c, lengths = random_problem(n, i, k, seed=n + i + k)
    lengths[::9] = -1
    _check(pack_bits(t), pack_bits(c), lengths, mode)


@pytest.mark.parametrize("n", [1, 77, 1000])
@pytest.mark.parametrize("mode", MODES)
def test_bitmap_count_edges(n, mode):
    """K1's edges (``k1_edge_problem``): exact against the JAX oracle, the
    Pallas kernel and the port's row-layout plain versions; the empty
    candidates count n (len 0) and, in popcount mode, 0 (len 3)."""
    tp, cp, lengths = k1_edge_problem(n, seed=n)
    got = _check(tp, cp, lengths, mode)
    rows = tref.support_count_packed_popcount_ref if mode == "popcount" else tref.support_count_packed_ref
    np.testing.assert_array_equal(got, rows(_words(tp), _words(cp), torch.from_numpy(lengths)).numpy())
    assert got[0] == n and got[1] == (n if mode == "and_cmp" else 0)
    assert (got[7::7] == 0).all()
    items = np.unpackbits(cp.view(np.uint8), axis=1).sum(1)
    assert {1, 4, 9, 40} <= set(items.tolist())
    if mode == "popcount":
        above = lengths > items
        assert above.any() and (got[above] == 0).all()
        below = (lengths >= 0) & (lengths < items)
        assert below.any() and (n == 1 or got[below].any())  # one row holds all of its candidates' items


@pytest.mark.parametrize("mode", MODES)
def test_bitmap_count_adds_over_row_slabs(mode):
    """Counts of row slabs of 64 rows (each slab's bitmaps masked past its
    own rows) add up to the whole count, as the kernel adds its slabs."""
    tp, cp, lengths = k1_edge_problem(300, seed=2)
    whole = _bitmap_counts(tp, cp, lengths, mode)
    parts = sum(_bitmap_counts(tp[lo : lo + 64], cp, lengths, mode) for lo in range(0, 300, 64))
    np.testing.assert_array_equal(parts, whole)
