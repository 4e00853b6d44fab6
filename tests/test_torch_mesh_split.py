"""PyTorch port: the mesh mine of rank-local splits (``apriori.mine(...,
split=True)``), the paper's cluster where each node holds only its own
HDFS blocks.

Each rank of a spawned gloo mesh loads only its own split from a file of
its own; the ranks exchange their splits' row counts, pad to the largest
split with inert rows and count.  On (4, 1) and (2, 2) meshes, with
unequal splits and with a split of no rows, in both representations, every
rank's result must equal the plain reference's over the splits
concatenated, the port's single-device ``mine`` of them and the JAX
package's.  Its observer counts the rows the rank held and the bytes each
level all-reduced, times the placement and the reduce, and counts the
levels, candidates and frequent itemsets the single device counts.
"""

import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from conftest import REPO_ROOT  # noqa: E402
from torch_obs_parity import PORT_ONLY_MINE_PHASES, port_only_counters  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.obs import MiningObs  # noqa: E402

sys.path.insert(0, REPO_ROOT)
from bench.reference import mine as ref_mine  # noqa: E402

DEADLINE_S = 60.0
SUPPORT, MAX_K = 0.06, 5
# rows of each data shard's split, in data-shard order: unequal, and one of none
SPLITS = {(4, 1): {"unequal": [120, 70, 90, 53], "empty": [150, 0, 100, 83]},
          (2, 2): {"unequal": [200, 133], "empty": [0, 333]}}
CASES = [(shape, name) for shape, splits in SPLITS.items() for name in splits]


@pytest.fixture(scope="module")
def whole():
    """The DB the splits make up, and its itemsets by the plain reference,
    the JAX package and the port's single device (observed)."""
    db = gen_transactions(QuestConfig(num_transactions=333, num_items=48, avg_len=8, seed=11))
    jax_dict = japr.mine(db, japr.AprioriConfig(min_support=SUPPORT, max_k=MAX_K, count_impl="jnp")).as_dict()
    ref = ref_mine.frequent_itemsets(db, SUPPORT, MAX_K)
    obs = MiningObs()
    single = mine(db, AprioriConfig(min_support=SUPPORT, max_k=MAX_K), device="cpu", obs=obs)
    assert ref == jax_dict == single.as_dict() and max(len(s) for s in ref) >= 3
    counters = obs.counters()
    assert counters["mine_split_rows"] == db.shape[0] and not any(k.startswith("mine_reduce") for k in counters)
    return dict(db=db, itemsets=ref, min_count=single.min_count, counters=counters)


def _cfgs(shape):
    model = dict(model_axis="model") if shape[1] > 1 else {}
    return [AprioriConfig(min_support=SUPPORT, max_k=MAX_K, representation=rep, data_axes=("data",), **model)
            for rep in ("dense", "packed")]


@pytest.mark.parametrize("shape,name", CASES, ids=[f"{s[0]}x{s[1]}-{n}" for s, n in CASES])
def test_split_mine_equals_the_whole_dbs_on_every_rank(whole, tmp_path, shape, name):
    db, sizes = whole["db"], SPLITS[shape][name]
    bounds = np.cumsum([0] + sizes)
    paths = []
    for d, (a, b) in enumerate(zip(bounds, bounds[1:])):
        paths.append(str(tmp_path / f"split{d}.npy"))
        np.save(paths[-1], db[a:b])
    got = spawn(ranks.split_mines, shape, ("data", "model"), device="cpu", backend="gloo", timeout_s=DEADLINE_S,
                args=(paths, _cfgs(shape)))
    def levels(c):   # the counters of levels, candidates and frequent itemsets
        extra = port_only_counters(c)
        return {k: v for k, v in c.items() if k not in extra and not k.startswith("mine_phase_seconds")}

    for rank, out in enumerate(got):
        assert out["rows"] == sizes[rank // shape[1]]
        for m in out["mines"]:
            assert m["itemsets"] == whole["itemsets"], (rank, name)
            assert (m["n"], m["min_count"]) == (db.shape[0], whole["min_count"])
            c = m["counters"]
            assert c["mine_split_rows"] == out["rows"]   # the rows of its own split, no more
            reduced = {k for k in c if k.startswith("mine_reduce_bytes{")}
            assert reduced == {f'mine_reduce_bytes{{level="{k}"}}' for k in range(1, c["mine_levels"] + 1)}
            assert all(c[k] > 0 for k in reduced)
            for p in PORT_ONLY_MINE_PHASES:
                assert c[f'mine_phase_seconds{{phase="{p}"}}'] > 0.0, p
            assert levels(c) == levels(whole["counters"])
        if shape[1] > 1:
            assert "do not make one DB" in out["disagree"]


def test_split_needs_a_mesh(whole):
    with pytest.raises(ValueError, match="needs a mesh"):
        mine(whole["db"], AprioriConfig(min_support=SUPPORT, max_k=MAX_K), device="cpu", split=True)

