"""PyTorch port: the candidate bucket splits evenly over the model shards
(mirrors ``tests/test_shard_divisibility.py``).

The JAX package's seed padded candidates to ``max(candidate_pad,
model_shards)``, which does not divide by 3 model shards; the quantum is
rounded up to a multiple of the shard count, and ``_pad_bucket`` only
doubles it.  A (2, 3) mesh (3 model shards, the bug's trigger) mines the
same dicts as one device in both representations, and each rank's
candidate block is a tensor of its own.
"""

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core.apriori import (  # noqa: E402
    AprioriConfig,
    _candidate_quantum,
    _pad_bucket,
    _place_candidates,
)
from repro_torch.launch.mesh import spawn  # noqa: E402


class _FakeMesh:
    """The shape and this rank's place on it: all the placement reads."""

    def __init__(self, shape, coords=None):
        self.shape = shape
        self.axes = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        self.coords = coords or {a: 0 for a in shape}

    def shard(self, axes):
        index, count = 0, 1
        for a in axes:
            index, count = index * self.shape[a] + self.coords[a], count * self.shape[a]
        return index, count


@pytest.mark.parametrize("shards,pad", [(1, 256), (2, 256), (3, 256), (5, 256), (6, 64), (7, 100)])
def test_candidate_quantum_divisible(shards, pad):
    cfg = AprioriConfig(candidate_pad=pad, model_axis="model")
    mesh = _FakeMesh({"data": 2, "model": shards})
    q = _candidate_quantum(cfg, mesh)
    assert q >= pad and q % shards == 0
    assert q == japr._candidate_quantum(japr.AprioriConfig(candidate_pad=pad, model_axis="model"), mesh)
    # every bucket grown from the quantum stays divisible
    for k in (1, pad - 1, pad + 1, 10 * pad + 3):
        assert _pad_bucket(k, q) % shards == 0
        assert _pad_bucket(k, q) >= k


def test_candidate_quantum_no_model_axis():
    cfg = AprioriConfig(candidate_pad=128, model_axis=None)
    assert _candidate_quantum(cfg, None) == 128
    assert _candidate_quantum(cfg, _FakeMesh({"data": 4, "model": 3})) == 128


@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_each_rank_places_its_own_candidate_block(rep):
    """Rank m of 3 model shards encodes rows [86m, 86m + 86) of the 258-row
    bucket as contiguous tensors that start their own storage (the kernels'
    16-byte-aligned bases), equal to that block of the whole placement."""
    rng = np.random.default_rng(0)
    cands = np.unique(np.sort(rng.integers(0, 64, size=(200, 2)), axis=1), axis=0)
    cands = cands[cands[:, 0] != cands[:, 1]].astype(np.int32)
    cfg = AprioriConfig(representation=rep, model_axis="model")
    kp = _pad_bucket(cands.shape[0], _candidate_quantum(cfg, _FakeMesh({"data": 2, "model": 3})))
    assert kp == 258
    whole_c, whole_len = _place_candidates(cands, kp, 64, cfg, "cpu")
    for m in range(3):
        mesh = _FakeMesh({"data": 2, "model": 3}, {"data": 1, "model": m})
        c, ln = _place_candidates(cands, kp, 64, cfg, "cpu", mesh)
        assert c.shape[0] == ln.shape[0] == 86 and c.is_contiguous() and c.storage_offset() == 0
        assert torch.equal(c, whole_c[86 * m : 86 * (m + 1)])
        assert torch.equal(ln, whole_len[86 * m : 86 * (m + 1)])


def test_mine_on_2x3_mesh():
    """Six ranks on a (2, 3) data x model mesh mine the JAX single-device
    dicts, for both representations."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    want = japr.mine(db, japr.AprioriConfig(min_support=0.05, max_k=4, count_impl="jnp")).as_dict()
    cfgs = [AprioriConfig(min_support=0.05, max_k=4, representation=rep, data_axes=("data",),
                          model_axis="model", candidate_pad=256) for rep in ("dense", "packed")]
    got = spawn(ranks.mine_dicts, (2, 3), ("data", "model"), device="cpu", backend="gloo",
                timeout_s=60.0, args=(db, cfgs))
    assert all(per_rank == [want, want] for per_rank in got)
