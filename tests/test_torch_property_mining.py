"""PyTorch port: the JAX package's property tests on mining
(``tests/test_property_mining.py``) run on the port's CPU ``mine``, in both
representations, with the port's dicts held equal to the JAX package's
``jnp`` mine of the same drawn DB."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis (see requirements.txt)")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402

REPRESENTATIONS = ["dense", "packed"]


@st.composite
def random_db(draw):
    n = draw(st.integers(20, 120))
    items = draw(st.integers(6, 20))
    density = draw(st.floats(0.1, 0.5))
    seed = draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    return (rng.random((n, items)) < density).astype(np.int8)


def _mine(db, rep, **kw):
    """The port's CPU mine, held dict-equal to the JAX package's."""
    res = mine(db, AprioriConfig(representation=rep, **kw), device="cpu")
    want = japr.mine(db, japr.AprioriConfig(representation=rep, count_impl="jnp", **kw))
    assert res.as_dict() == want.as_dict()
    assert res.min_count == want.min_count
    return res


@pytest.mark.parametrize("rep", REPRESENTATIONS)
@given(db=random_db(), min_support=st.floats(0.05, 0.5))
@settings(max_examples=25, deadline=None)
def test_downward_closure_and_support_bounds(rep, db, min_support):
    """Anti-monotonicity: every subset of a frequent itemset is frequent with
    support >= the superset's; all supports lie in [min_count, N]."""
    res = _mine(db, rep, min_support=min_support, max_k=4)
    d = res.as_dict()
    n = db.shape[0]
    for itemset, sup in d.items():
        assert res.min_count <= sup <= n
        if len(itemset) >= 2:
            for drop in range(len(itemset)):
                sub = tuple(x for j, x in enumerate(itemset) if j != drop)
                assert sub in d, f"subset {sub} of frequent {itemset} missing"
                assert d[sub] >= sup


@pytest.mark.parametrize("rep", REPRESENTATIONS)
@given(db=random_db())
@settings(max_examples=15, deadline=None)
def test_threshold_monotonicity(rep, db):
    """Raising min_support can only shrink the frequent set (and the survivors
    keep identical supports)."""
    lo = _mine(db, rep, min_support=0.1, max_k=3).as_dict()
    hi = _mine(db, rep, min_support=0.3, max_k=3).as_dict()
    assert set(hi) <= set(lo)
    for k, v in hi.items():
        assert lo[k] == v


@pytest.mark.parametrize("rep", REPRESENTATIONS)
@given(db=random_db(), seed=st.integers(2, 5))
@settings(max_examples=10, deadline=None)
def test_row_permutation_invariance(rep, db, seed):
    """Transaction order must not matter (the Map phase is a bag, not a list)."""
    perm = np.random.default_rng(seed).permutation(db.shape[0])
    assert _mine(db, rep, min_support=0.15, max_k=3).as_dict() == \
        _mine(db[perm], rep, min_support=0.15, max_k=3).as_dict()


@pytest.mark.parametrize("rep", REPRESENTATIONS)
@given(db=random_db())
@settings(max_examples=10, deadline=None)
def test_supports_equal_exact_counts(rep, db):
    """Reported support == literal containment count for every winner."""
    res = _mine(db, rep, min_support=0.2, max_k=3)
    for itemset, sup in list(res.as_dict().items())[:50]:
        assert int(db[:, list(itemset)].all(axis=1).sum()) == sup
