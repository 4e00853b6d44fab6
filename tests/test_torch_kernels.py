"""PyTorch port: the kernels' plain versions and the ops wrappers on the CPU,
held against the JAX package's oracles and its Pallas kernels in interpret
mode.  Counts are exact; rule-match scores agree within rtol=1e-5,
atol=1e-6 (fp32 sums taken in another order)."""

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.itemsets import pack_bits, packed_words  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import random_problem  # noqa: E402
from test_kernels import SHAPES  # noqa: E402
from test_rule_match import RULE_SHAPES, random_rule_problem  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _words(x: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 view tensor (bit-identical)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _packed_problem(shape):
    n, i, k = shape
    t, c, lengths = random_problem(n, i, k, seed=n + i + k)
    return pack_bits(t), pack_bits(c), lengths


# ------------------------------------------------------------------ K1 -------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
def test_support_count_plain_matches_jax(shape, mode):
    """The plain version (what CPU tensors take) is exact against the JAX
    oracle and the Pallas kernel in interpret mode, in both modes."""
    tp, cp, lengths = _packed_problem(shape)
    want = np.asarray(jref.support_count_packed_ref(jnp.asarray(tp), jnp.asarray(cp), jnp.asarray(lengths)))
    pallas = np.asarray(jops.support_count_packed(
        jnp.asarray(tp), jnp.asarray(cp), jnp.asarray(lengths),
        impl="pallas_interpret", mode=mode, block_n=64, block_k=128, block_w=2))
    got = tops.support_count_packed(_words(tp), _words(cp), torch.from_numpy(lengths), mode=mode)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_support_count_ref_without_lengths(shape):
    """lengths=None: every row is a real candidate (the JAX oracle's all-ones
    block padding never reaches its output)."""
    tp, cp, _ = _packed_problem(shape)
    want = np.asarray(jref.support_count_packed_ref(jnp.asarray(tp), jnp.asarray(cp), block_k=32))
    got = tref.support_count_packed_ref(_words(tp), _words(cp), block_k=32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["and_cmp", "popcount"])
def test_support_count_padding_inert(mode):
    """Zero transaction rows, zero words and len = -1 candidate rows change
    no count; an all-padding pass counts zero."""
    t, c, lengths = random_problem(64, 48, 16, seed=5)
    tp, cp = pack_bits(t), pack_bits(c)
    want = tops.support_count_packed(_words(tp), _words(cp), torch.from_numpy(lengths), mode=mode).numpy()
    tp_pad = np.pad(tp, ((0, 40), (0, 2)))
    cp_pad = np.pad(cp, ((0, 7), (0, 2)))
    len_pad = np.concatenate([lengths, np.full(7, -1, np.int32)])
    got = tops.support_count_packed(_words(tp_pad), _words(cp_pad), torch.from_numpy(len_pad), mode=mode).numpy()
    np.testing.assert_array_equal(got[:16], want)
    np.testing.assert_array_equal(got[16:], 0)
    allpad = tops.support_count_packed(
        _words(tp), torch.zeros((12, tp.shape[1]), dtype=torch.int32),
        torch.full((12,), -1, dtype=torch.int32), mode=mode)
    np.testing.assert_array_equal(allpad.numpy(), 0)


def test_support_count_wrapper_checks():
    tp, cp, lengths = _packed_problem(SHAPES[0])
    t, c, ln = _words(tp), _words(cp), torch.from_numpy(lengths)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.support_count_packed(t, c, ln, impl="kernel")
    with pytest.raises(TypeError):
        tops.support_count_packed(t.to(torch.int64), c, ln)
    with pytest.raises(ValueError):
        tops.support_count_packed(t, c[:, :0], ln)
    with pytest.raises(ValueError):
        tops.support_count_packed(t, c, ln[:-1])
    with pytest.raises(ValueError):
        tops.support_count_packed(t, c, ln, mode="bogus")
    with pytest.raises(ValueError):
        tops.support_count_packed(t, c, ln, impl="pallas")
    with pytest.raises(ValueError):
        tops.support_count_packed(t.t(), c, ln)  # not contiguous
    before = tops.launch_counts()
    tops.support_count_packed(t, c, ln, impl="ref")
    assert tops.launch_counts() == before  # the plain version is no launch


# ------------------------------------------------------------------ K2 -------
@pytest.mark.parametrize("shape", RULE_SHAPES)
def test_rule_match_plain_matches_jax(shape):
    b, i, r = shape
    prob = random_rule_problem(b, i, r, seed=sum(shape))
    jargs = [jnp.asarray(x) for x in prob]
    want_jnp = np.asarray(jops.rule_match(*jargs, num_items=i, impl="jnp"))
    want_pal = np.asarray(jops.rule_match(*jargs, num_items=i, impl="pallas_interpret", block_n=32, block_k=128))
    bk, ante, lengths, cons, scores = prob
    got = tops.rule_match(_words(bk), _words(ante), torch.from_numpy(lengths), _words(cons),
                          torch.from_numpy(scores), num_items=i, block_n=16)
    assert got.shape == (b, i) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_jnp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_pal, rtol=RTOL, atol=ATOL)
    full = tref.rule_match_ref(_words(bk), _words(ante), torch.from_numpy(lengths), _words(cons),
                               torch.from_numpy(scores))
    np.testing.assert_allclose(full.numpy()[:, :i], want_jnp, rtol=RTOL, atol=ATOL)


def test_rule_match_all_padding_rules_and_zero_baskets():
    baskets, ante, lengths, cons, scores = random_rule_problem(20, 64, 40, seed=9, pad_frac=0)
    r, w = 12, packed_words(64)
    z = torch.zeros((r, w), dtype=torch.int32)
    out = tops.rule_match(_words(baskets), z, torch.full((r,), -1, dtype=torch.int32), z,
                          torch.zeros(r), num_items=64)
    np.testing.assert_array_equal(out.numpy(), 0.0)
    zb = torch.zeros((8, w), dtype=torch.int32)
    out = tops.rule_match(zb, _words(ante), torch.from_numpy(lengths), _words(cons),
                          torch.from_numpy(scores), num_items=64)
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_rule_match_exact_containment_semantics():
    """Hand-built case of tests/test_rule_match.py: out[b] sums the scores
    of exactly the contained rules."""
    from repro.core.itemsets import itemsets_to_packed

    i = 40
    baskets = pack_bits(np.asarray(
        [[1 if x in (0, 1, 35) else 0 for x in range(i)], [1 if x == 2 else 0 for x in range(i)]], np.int8))
    ante = itemsets_to_packed(np.array([[0, 35], [2, 2]], np.int32), i)
    cons = itemsets_to_packed(np.array([[2, 2], [0, 0]], np.int32), i)
    out = tops.rule_match(_words(baskets), _words(ante), torch.tensor([2, 1], dtype=torch.int32),
                          _words(cons), torch.tensor([0.5, 2.0]), num_items=i).numpy()
    want = np.zeros((2, i), np.float32)
    want[0, 2] = 0.5
    want[1, 0] = 2.0
    np.testing.assert_array_equal(out, want)


def test_rule_match_wrapper_checks():
    bk, ante, lengths, cons, scores = random_rule_problem(8, 40, 6, seed=1)
    args = [_words(bk), _words(ante), torch.from_numpy(lengths), _words(cons), torch.from_numpy(scores)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.rule_match(*args, impl="kernel")
    with pytest.raises(TypeError):
        tops.rule_match(*args[:4], args[4].double())
    with pytest.raises(ValueError):
        tops.rule_match(args[0][:, :1], *args[1:])
    with pytest.raises(ValueError):
        tops.rule_match(args[0], args[1], args[2][:-1], args[3], args[4])
