"""PyTorch port: the streamed, incremental and checkpointed miners on a
mesh of spawned CPU ranks (mirrors ``tests/test_streaming.py``'s (2, 3)
mesh test, on the same store, and carries it to the delta miner and to
checkpoints).

* ``mine_streamed`` and ``mine_son_streamed`` on (2, 3), both
  representations, at ``chunk_rows=67`` (rounded up to 68);
* ``count_union_streamed``, ``build_count_cache`` and ``mine_delta`` on
  (2, 2), dict-identical to the JAX package's, the mesh-written count cache
  read by the JAX package;
* a mesh mine stopped after its second save resumes without a mesh (in
  both packages), and a mine stopped without a mesh resumes on the mesh.

One spawn per mesh (module fixtures), each with a 90 s deadline.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core import incremental as jinc  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.data import store as jds  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.distributed import checkpoint as jck  # noqa: E402
from repro_torch.core.apriori import AprioriConfig  # noqa: E402
from repro_torch.core.streaming import mine_streamed  # noqa: E402
from repro_torch.data.store import open_store  # noqa: E402
from repro_torch.distributed.checkpoint import MiningCheckpoint  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

QCFG = QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13)
JCFG = japr.AprioriConfig(min_support=0.05, max_k=4, count_impl="jnp", representation="packed")
CFG = AprioriConfig(min_support=0.05, max_k=4, representation="packed")


def _spawn(fn, shape, *args):
    return spawn(fn, shape, ("data", "model"), device="cpu", backend="gloo", timeout_s=90.0, args=args)


@pytest.fixture(scope="module")
def want():
    """The single-device in-memory mine of the store's DB (JAX package)."""
    return japr.mine(gen_transactions(QCFG), japr.AprioriConfig(min_support=0.05, max_k=4,
                                                                count_impl="jnp")).as_dict()


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh-stream") / "store")
    jds.ingest_quest(QCFG, path, shard_rows=90)
    return path


@pytest.fixture(scope="module")
def on_2x3(store_path):
    return _spawn(ranks.stream_2x3, (2, 3), store_path)


@pytest.fixture(scope="module")
def on_2x2(store_path, want, tmp_path_factory):
    """Runs the (2, 2) ranks, and beforehand the two mines they are held
    against: the JAX package's delta mine on a copy of the store, and a
    mine stopped without a mesh after its second save."""
    root = tmp_path_factory.mktemp("mesh-2x2")
    extra = gen_transactions(QuestConfig(num_transactions=60, num_items=64, avg_len=8, seed=99))
    jax_delta = str(root / "jax-delta")
    shutil.copytree(store_path, jax_delta)
    jinc.build_count_cache(jds.open_store(jax_delta), JCFG, chunk_rows=64)
    jds.append_chunks([extra], jax_delta)
    jres, jrep = jinc.mine_delta(jds.open_store(jax_delta), JCFG, chunk_rows=64)
    port_delta = str(root / "port-delta")
    shutil.copytree(store_path, port_delta)
    stop, resume = str(root / "ck-mesh"), str(root / "ck-single")
    with pytest.raises(ranks.Stop):
        mine_streamed(open_store(store_path), CFG, device="cpu", chunk_rows=64,
                      checkpoint=ranks.StopAfter(resume, 2), checkpoint_every_chunks=1)
    per_level = {k: np.array(sorted(s for s in want if len(s) == k), np.int32) for k in (1, 2, 3)}
    got = _spawn(ranks.stream_2x2, (2, 2), store_path, per_level, port_delta, extra, stop, resume)
    return dict(got=got, per_level=per_level, jres=jres.as_dict(), jrep=jrep, jax_delta=jax_delta,
                port_delta=port_delta, stop=stop)


@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_mine_streamed_on_2x3(on_2x3, want, rep):
    """Every rank's streamed mine equals the single-device mine; the chunk
    of 67 rows was rounded up to 68, two data shards of 34."""
    for per_rank in on_2x3:
        assert per_rank[rep]["chunk_rows"] == 68
        assert per_rank[rep]["streamed"] == want


@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_mine_son_streamed_on_2x3(on_2x3, want, rep):
    for per_rank in on_2x3:
        assert per_rank[rep]["son"] == want


def test_count_union_streamed_on_2x2_matches_jax(on_2x2, store_path):
    jcounts = jstream.count_union_streamed(jds.open_store(store_path), on_2x2["per_level"], JCFG,
                                           chunk_rows=64)
    for per_rank in on_2x2["got"]:
        assert sorted(per_rank["union"]) == sorted(jcounts)
        for k in jcounts:
            np.testing.assert_array_equal(per_rank["union"][k], np.asarray(jcounts[k]))


def test_count_cache_and_mine_delta_on_2x2_match_jax(on_2x2, want):
    """The mesh's count cache (rank 0 wrote it) seeds a delta mine of the
    60 appended rows: mode ``delta``, dict-identical to the JAX package's
    delta mine; the advanced cache, read by the JAX package, equals the one
    the JAX package wrote."""
    jrep = on_2x2["jrep"]
    assert jrep.mode == "delta"
    for per_rank in on_2x2["got"]:
        assert per_rank["built"] == want and per_rank["cache_seq"] == 1
        assert per_rank["delta"] == on_2x2["jres"]
        assert per_rank["report"]["mode"] == "delta"
        assert per_rank["report"]["novel_candidates"] == jrep.novel_candidates
    mesh_cache = jinc.load_count_cache(jds.open_store(on_2x2["port_delta"]))
    jax_cache = jinc.load_count_cache(jds.open_store(on_2x2["jax_delta"]))
    assert (mesh_cache.seq, mesh_cache.n, mesh_cache.store_fp) == (jax_cache.seq, jax_cache.n, jax_cache.store_fp)
    assert sorted(mesh_cache.levels) == sorted(jax_cache.levels)
    for k in jax_cache.levels:
        for a, b in zip(mesh_cache.levels[k], jax_cache.levels[k]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_mesh_checkpoint_resumes_without_a_mesh(on_2x2, store_path, want, reader, tmp_path):
    """The checkpoint a (2, 2) mine committed at its second save holds whole
    counts: the port without a mesh, and the JAX package, resume it to the
    uninterrupted mine's dict."""
    assert all(per_rank["stopped"] for per_rank in on_2x2["got"])
    ck = str(tmp_path / "ck")
    shutil.copytree(on_2x2["stop"], ck)
    assert MiningCheckpoint(ck).load_latest() is not None
    if reader == "port":
        got = mine_streamed(open_store(store_path), CFG, device="cpu", chunk_rows=64,
                            checkpoint=MiningCheckpoint(ck), checkpoint_every_chunks=1, resume=True)
    else:
        got = jstream.mine_streamed(jds.open_store(store_path), JCFG, chunk_rows=64,
                                    checkpoint=jck.MiningCheckpoint(ck), checkpoint_every_chunks=1,
                                    resume=True)
    assert got.as_dict() == want


def test_single_device_checkpoint_resumes_on_a_mesh(on_2x2, want):
    for per_rank in on_2x2["got"]:
        assert per_rank["resumed"] == want
