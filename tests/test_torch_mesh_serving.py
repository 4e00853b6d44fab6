"""PyTorch port: rulebooks placed on a mesh and batched ``recommend`` over
spawned CPU ranks (mirrors ``tests/test_rulebook.py``'s mesh tests).

On a (2, 3) data x model mesh the rulebook's rows pad to a multiple of the
3 rule shards (the uneven-split trigger) and each rank keeps one block;
baskets split over the 2 data shards; each rule block's partial scores are
summed over the rule axis.  The scores are held to the JAX package's
single-device ``recommend(impl="jnp")`` and to ``recommend_python`` within
rtol 1e-5, atol 1e-6 (the all-reduce adds the rule blocks in the backend's
order), and the items are equal except where two scores lie within that
tolerance of each other.
"""

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.serving.recommend import recommend as jrecommend  # noqa: E402
from repro.serving.rulebook import compile_rulebook as jcompile  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.serving.recommend import recommend_python  # noqa: E402
from repro_torch.serving.rulebook import rulebook_from_arrays  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def served():
    """The JAX test's rulebook, its single-device recommend of 90 baskets,
    the Python oracle's, and the port's copy of the rulebook."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    res = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    # 2,071 rules in 2,072 rows (the JAX test's pad of 64 gives 2,112, which
    # 3 divides): the uneven split over 3 rule shards is exercised
    jrb = jcompile(res, min_confidence=0.4, num_items=64, pad_multiple=8)
    rb = rulebook_from_arrays(jrb.ante_packed, jrb.cons_packed, jrb.ante_len, jrb.scores, 64,
                              jrb.score_kind, jrb.min_confidence)
    baskets = db[:90]
    want = jrecommend(jrb, baskets, top_k=5, batch_size=30, impl="jnp")
    oracle = recommend_python(rb, baskets, top_k=5)
    return rb, baskets, want, oracle


def _held(items, scores, want):
    """Scores within tolerance; items equal wherever the reference's scores
    are apart by more than the tolerance (a tie may order either way)."""
    np.testing.assert_allclose(scores, want.scores, rtol=RTOL, atol=ATOL)
    s = np.asarray(want.scores)
    tie = np.abs(np.diff(s, axis=1)) <= ATOL + RTOL * np.abs(s[:, 1:])
    close = np.zeros_like(s, dtype=bool)
    close[:, 1:] |= tie
    close[:, :-1] |= tie
    np.testing.assert_array_equal(items[~close], np.asarray(want.items)[~close])


@pytest.fixture(scope="module")
def on_2x3(served):
    rb, baskets, _, _ = served
    return spawn(ranks.serve, (2, 3), ("data", "model"), device="cpu", backend="gloo", timeout_s=60.0,
                 args=(rb, baskets, 5, 30))


def test_place_rulebook_on_2x3_pads_to_the_rule_shards(served, on_2x3):
    rb = served[0]
    assert rb.num_rows % 3 != 0   # the uneven split the padding exists for
    for per_rank in on_2x3:
        assert per_rank["num_rows"] % 3 == 0 and per_rank["num_rows"] - rb.num_rows < 3
        assert per_rank["num_rules"] == rb.num_rules
        assert per_rank["local_rows"] == per_rank["num_rows"] // 3
        # a rulebook placed without the mesh is refused on it, and a placed
        # block has no whole rulebook to hand back to the host
        assert per_rank["refused"] == ["recommend", "to_host"]


@pytest.mark.parametrize("ref", ["jax", "python"])
def test_recommend_on_2x3_matches_single_device(served, on_2x3, ref):
    """Three uneven rule shards, two basket shards, a batch of 30 (15 a data
    shard): every rank returns the whole result, the same on every rank."""
    _, _, want, oracle = served
    target = want if ref == "jax" else oracle
    first = on_2x3[0]
    for per_rank in on_2x3:
        _held(per_rank["items"], per_rank["scores"], target)
        _held(per_rank["host_items"], per_rank["host_scores"], target)
        np.testing.assert_array_equal(per_rank["items"], first["items"])
        np.testing.assert_array_equal(per_rank["scores"], first["scores"])


def test_recommend_on_1x1_mesh_takes_the_single_device_path(served):
    rb, baskets, want, _ = served
    (got,) = spawn(ranks.serve, (1, 1), ("data", "model"), device="cpu", backend="gloo", timeout_s=60.0,
                   args=(rb, baskets, 5, 30))
    assert got["num_rows"] == got["local_rows"] == rb.num_rows and got["num_rules"] == rb.num_rules
    _held(got["items"], got["scores"], want)
