"""PyTorch port: the mesh mine over NCCL across cards, one rank a card.

``Mesh.wait`` on NCCL collectives (a late peer, an abort, a rebuilt mesh)
and the mine of rank-local splits (``apriori.mine(..., split=True)``) on
the cards against one card's.  Marked ``gpu``; each test skips without two
CUDA cards (NCCL takes one rank a card).  Run on the cards with

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_mesh_nccl.py
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks  # noqa: E402
from conftest import REPO_ROOT  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

sys.path.insert(0, REPO_ROOT)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA cards: NCCL takes one rank a card")
    return min(n, 4)


def test_nccl_mesh_waits_for_a_late_peer_and_lets_go_on_abort(cards):
    """``Mesh.wait`` on NCCL collectives across cards: an all-reduce whose
    last rank enters 0.5 s late ends with the right sum on every rank (a
    timed wait of 50 ms would have failed it); an abort releases the ranks
    waiting in a collective the aborting rank never entered; the ranks then
    build a twin, destroy the aborted mesh and all-reduce on the twin."""
    got = spawn(ranks.nccl_waits, (cards, 1), ("data", "model"), device="cuda", backend="nccl", timeout_s=120,
                args=(0.5,))
    print(got)
    for rank, out in enumerate(got):
        assert out["late"] == cards and out["twin"] == cards, out
        assert out["destroyed"], out
        if rank < cards - 1:
            assert out["late_wait_s"] >= 0.3 and f"rank {cards - 1} aborted the mesh" in out["aborted"], out
            assert out["abort_s"] < 5.0, out


def test_split_mine_over_nccl_across_cards_equals_one_card(cards, tmp_path):
    """Four (or as many as there are) ranks a card over NCCL, each holding
    a split of four T10 blocks of 100,000 rows, mine dense (K3) and packed
    (K1) the single card's itemsets; each counted its own rows and timed
    its passes' reduce."""
    from bench.data import quest
    from bench.harness import _json

    data = _json("configs", "quest-t10i4d100k")["data"]
    q = quest.Quest.from_config(data)
    blocks = [quest.generate(q, data["data_seed"], rows=100000, stream=b) for b in range(4)]
    sizes = [len(p) for p in np.array_split(np.arange(4), cards)]
    paths, at = [], 0
    for d, k in enumerate(sizes):
        paths.append(str(tmp_path / f"split{d}.npy"))
        np.save(paths[-1], np.concatenate(blocks[at : at + k]))
        at += k
    cfgs = [AprioriConfig(min_support=0.002, max_k=4, representation=rep, data_axes=("data",))
            for rep in ("dense", "packed")]
    got = spawn(ranks.split_mines_on_cards, (cards, 1), ("data", "model"), device="cuda", backend="nccl",
                timeout_s=300, args=(paths, cfgs))
    want = mine(np.concatenate(blocks), cfgs[0], device="cuda").as_dict()
    assert len(want) > 1000
    for rank, outs in enumerate(got):
        for out in outs:
            assert out["itemsets"] == want, rank
            assert out["split_rows"] == 100000 * sizes[rank] and out["reduce_bytes"] > 0
            assert out["phases"]["count_reduce"] > 0.0 and out["phases"]["db_place"] > 0.0
