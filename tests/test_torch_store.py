"""PyTorch port: the on-disk transaction store (``repro_torch.data.store``).
Its files are the JAX package's byte for byte (shards and manifest, both
ingest paths and appends), each package opens and mines the other's store,
and the port's copy keeps the reference's ingest, manifest, chunk, seek,
append and shard-range semantics (mirrors ``tests/test_store.py``)."""

import json
import os

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.data import store as jst  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core.itemsets import pack_bits, packed_words  # noqa: E402
from repro_torch.data import store as st  # noqa: E402
from repro_torch.data.synthetic import QuestConfig, gen_transactions  # noqa: E402


def _rand_dense(n, i, seed=0, density=0.25):
    rng = np.random.default_rng(seed)
    return (rng.random((n, i)) < density).astype(np.int8)


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read() for name in sorted(os.listdir(path))}


# ------------------------------------------------- the JAX package's bytes ---
@pytest.mark.parametrize("n,i,shard_rows", [(100, 37, 30), (64, 32, 64), (257, 65, 100), (10, 7, 1000)])
def test_ingest_dense_roundtrip_byte_equal_to_jax(tmp_path, n, i, shard_rows):
    dense = _rand_dense(n, i, seed=n)
    s = st.ingest_dense(dense, str(tmp_path / "t"), shard_rows=shard_rows)
    jst.ingest_dense(dense, str(tmp_path / "j"), shard_rows=shard_rows)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert s.num_transactions == n and s.num_items == i
    assert all(r == shard_rows for r in s.manifest.shard_rows[:-1])
    assert np.array_equal(s.read_dense(), dense)


def test_ingest_quest_byte_equal_to_jax(tmp_path):
    """Both packages ingest the same Quest config into the same files, and
    the rows are the generator's."""
    qcfg = QuestConfig(num_transactions=300, num_items=48, avg_len=7, seed=11)
    s = st.ingest_quest(qcfg, str(tmp_path / "t"), shard_rows=77, chunk_rows=41)
    jst.ingest_quest(qcfg, str(tmp_path / "j"), shard_rows=77, chunk_rows=41)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert np.array_equal(s.read_dense(), gen_transactions(qcfg))
    assert st.LAYOUT_VERSION == jst.LAYOUT_VERSION and st.LAYOUT_NAME == jst.LAYOUT_NAME


def test_append_byte_equal_to_jax(tmp_path):
    base, extra = _rand_dense(64, 16, seed=3), _rand_dense(50, 16, seed=4)
    for name, mod in (("t", st), ("j", jst)):
        mod.ingest_dense(base, str(tmp_path / name), shard_rows=16)
        mod.append_chunks([extra[:20], pack_bits(extra[20:])], str(tmp_path / name))
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("representation", ["dense", "packed"])
def test_each_package_opens_and_mines_the_others_store(tmp_path, small_db, representation):
    jcfg = japr.AprioriConfig(min_support=0.05, max_k=4, count_impl="jnp", representation=representation)
    tcfg = tapr.AprioriConfig(min_support=0.05, max_k=4, representation=representation)
    st.ingest_dense(small_db, str(tmp_path / "t"), shard_rows=90)
    jst.ingest_dense(small_db, str(tmp_path / "j"), shard_rows=90)
    by_jax = jstream.mine_streamed(jst.open_store(str(tmp_path / "t")), jcfg, chunk_rows=77)
    by_port = tstream.mine_streamed(st.open_store(str(tmp_path / "j")), tcfg, device="cpu", chunk_rows=77)
    assert by_jax.as_dict() == by_port.as_dict() == tapr.mine(small_db, tcfg, device="cpu").as_dict()


# --------------------------------------------------------------- ingest -----
def test_ingest_lists_matches_dense(tmp_path):
    dense = _rand_dense(50, 40, seed=2)
    lists = [np.flatnonzero(r).tolist() for r in dense]
    s1 = st.ingest_lists(lists, 40, str(tmp_path / "a"), shard_rows=16, chunk_rows=7)
    s2 = st.ingest_dense(dense, str(tmp_path / "b"), shard_rows=16)
    assert np.array_equal(s1.read_dense(), s2.read_dense())


def test_ingest_chunks_accepts_dense_and_packed(tmp_path):
    dense = _rand_dense(45, 33, seed=3)
    s1 = st.ingest_chunks([dense[:20], dense[20:]], 33, str(tmp_path / "a"), shard_rows=16)
    s2 = st.ingest_chunks([pack_bits(dense[:10]), pack_bits(dense[10:])], 33, str(tmp_path / "b"), shard_rows=16)
    assert np.array_equal(s1.read_dense(), dense)
    assert np.array_equal(s2.read_dense(), dense)


# --------------------------------------------------------------- manifest ---
def test_manifest_schema_and_mmap(tmp_path):
    dense = _rand_dense(80, 70, seed=4)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=32)
    with open(os.path.join(s.path, st.MANIFEST_NAME)) as f:
        d = json.load(f)
    assert d["version"] == st.LAYOUT_VERSION and d["layout"] == st.LAYOUT_NAME
    assert d["n"] == 80 and d["num_items"] == 70 and d["words"] == packed_words(70)
    assert d["shard_rows"] == [32, 32, 16]
    part = s.partition_packed(0)
    assert isinstance(part, np.memmap) and part.dtype == np.uint32
    assert np.array_equal(s.partition_dense(2), dense[64:])


def test_open_store_rejects_version_mismatch_and_missing_manifest(tmp_path):
    with pytest.raises(FileNotFoundError):
        st.open_store(str(tmp_path / "nowhere"))
    s = st.ingest_dense(_rand_dense(10, 8), str(tmp_path / "db"), shard_rows=8)
    mpath = os.path.join(s.path, st.MANIFEST_NAME)
    with open(mpath) as f:
        d = json.load(f)
    d["version"] = st.LAYOUT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="layout version"):
        st.open_store(s.path)


def test_reingest_invalidates_old_manifest_and_shards(tmp_path):
    path = str(tmp_path / "db")
    st.ingest_dense(_rand_dense(50, 8, seed=1), path, shard_rows=8)  # 7 shards
    s = st.ingest_dense(_rand_dense(12, 8, seed=2), path, shard_rows=8)
    assert s.num_transactions == 12
    assert np.array_equal(st.open_store(path).read_dense(), _rand_dense(12, 8, seed=2))
    assert sorted(f for f in os.listdir(path) if f.startswith("shard_")) == [
        st.shard_filename(0), st.shard_filename(1)]


def test_writer_rejects_shape_mismatch(tmp_path):
    w = st.StoreWriter(str(tmp_path / "db"), num_items=16, shard_rows=8)
    with pytest.raises(ValueError):
        w.append_dense(np.zeros((4, 17), np.int8))
    with pytest.raises(ValueError):
        w.append_packed(np.zeros((4, 3), np.uint32))


def test_manifest_checkpoint_dir_and_backward_compat(tmp_path):
    s = st.ingest_dense(_rand_dense(10, 8), str(tmp_path / "db"), shard_rows=8)
    assert s.checkpoint_path == os.path.join(s.path, st.DEFAULT_CHECKPOINT_DIR)
    mpath = os.path.join(s.path, st.MANIFEST_NAME)
    with open(mpath) as f:
        d = json.load(f)
    del d["checkpoint_dir"]
    with open(mpath, "w") as f:
        json.dump(d, f)
    assert st.open_store(s.path).checkpoint_path == os.path.join(s.path, st.DEFAULT_CHECKPOINT_DIR)


# ----------------------------------------------------------------- chunks ---
@pytest.mark.parametrize("chunk_rows", [1, 13, 30, 100, 1000])
def test_iter_chunks_equal_jax_in_both_representations(tmp_path, chunk_rows):
    """``iter_chunks`` yields the JAX package's chunks, packed and dense (the
    dense read stays for API parity: the streamed miners read packed)."""
    dense = _rand_dense(100, 37, seed=5)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=30)
    j = jst.open_store(s.path)
    for rep in ("dense", "packed"):
        got = list(s.iter_chunks(chunk_rows, representation=rep))
        want = list(j.iter_chunks(chunk_rows, representation=rep))
        assert len(got) == len(want)
        for (a, va), (b, vb) in zip(got, want):
            assert va == vb == a.shape[0] <= chunk_rows
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if rep == "dense":
            assert np.array_equal(np.concatenate([c for c, _ in got]), dense)


def test_iter_chunks_packed_matches_pack_bits(tmp_path):
    dense = _rand_dense(64, 48, seed=6)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=25)
    got = np.concatenate([c for c, _ in s.iter_chunks(17, representation="packed")])
    assert np.array_equal(got, pack_bits(dense))


def test_iter_chunks_pad_fixed_shape(tmp_path):
    dense = _rand_dense(50, 32, seed=7)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=20)
    chunks = list(s.iter_chunks(16, representation="packed", pad=True))
    assert [c.shape[0] for c, _ in chunks] == [16, 16, 16, 16]
    assert [v for _, v in chunks] == [16, 16, 16, 2]
    last, valid = chunks[-1]
    assert np.array_equal(last[valid:], np.zeros((14, last.shape[1]), np.uint32))
    assert np.array_equal(np.concatenate([c[:v] for c, v in chunks]), pack_bits(dense))


def test_iter_chunks_rejects_bad_args(tmp_path):
    s = st.ingest_dense(_rand_dense(10, 8), str(tmp_path / "db"))
    with pytest.raises(ValueError):
        list(s.iter_chunks(0))
    with pytest.raises(ValueError):
        list(s.iter_chunks(4, representation="sparse"))
    with pytest.raises(ValueError):
        list(s.iter_chunks(4, start_chunk=-1))
    assert list(s.iter_chunks(8, start_chunk=100)) == []


@pytest.mark.parametrize("chunk_rows,shard_rows", [(13, 30), (30, 30), (7, 100), (64, 25)])
def test_iter_chunks_start_chunk_equals_skipping(tmp_path, chunk_rows, shard_rows):
    dense = _rand_dense(100, 37, seed=8)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=shard_rows)
    full = list(s.iter_chunks(chunk_rows, representation="packed", pad=True))
    for k in range(len(full) + 1):
        tail = list(s.iter_chunks(chunk_rows, representation="packed", pad=True, start_chunk=k))
        assert len(tail) == len(full) - k
        for (want, wv), (got, gv) in zip(full[k:], tail):
            assert wv == gv and np.array_equal(want, got)


def test_iter_chunks_shard_range(tmp_path):
    dense = _rand_dense(100, 16, seed=12)
    s = st.ingest_dense(dense, str(tmp_path / "db"), shard_rows=17)
    rows = s.manifest.shard_rows
    for s0, s1 in [(0, 2), (2, 5), (0, s.num_partitions), (3, 3)]:
        got = [c for c, v in s.iter_chunks(7, representation="dense", shards=(s0, s1))]
        lo = sum(rows[:s0])
        want = dense[lo : lo + sum(rows[s0:s1])]
        assert np.array_equal(np.concatenate(got) if got else np.zeros((0, 16)), want)
    with pytest.raises(ValueError):
        list(s.iter_chunks(7, shards=(3, 2)))
    with pytest.raises(ValueError):
        list(s.iter_chunks(7, shards=(0, s.num_partitions + 1)))


# ------------------------------------------------------------ append mode ---
def test_open_for_append_roundtrip(tmp_path):
    base, extra = _rand_dense(100, 24, seed=1), _rand_dense(37, 24, seed=2)
    p = str(tmp_path / "db")
    s0 = st.ingest_dense(base, p, shard_rows=32)
    base_shards = s0.num_partitions
    mtimes = {i: os.path.getmtime(s0.shard_path(i)) for i in range(base_shards)}
    w = st.StoreWriter.open_for_append(p)
    w.append_dense(extra)
    s1 = w.close()
    assert s1.num_transactions == 137
    assert np.array_equal(s1.read_dense(), np.concatenate([base, extra]))
    assert s1.manifest.shard_rows[:base_shards] == s0.manifest.shard_rows
    assert {i: os.path.getmtime(s1.shard_path(i)) for i in range(base_shards)} == mtimes
    assert s1.manifest.seq == s0.manifest.seq + 1
    assert not os.path.exists(os.path.join(p, st.MANIFEST_NAME + ".tmp"))


def test_torn_append_leaves_old_manifest_readable(tmp_path):
    base = _rand_dense(80, 16, seed=5)
    p = str(tmp_path / "db")
    s0 = st.ingest_dense(base, p, shard_rows=32)
    w = st.StoreWriter.open_for_append(p)
    w.append_dense(_rand_dense(64, 16, seed=6))
    w._flush()
    orphan = os.path.join(p, st.shard_filename(s0.num_partitions))
    assert os.path.exists(orphan)
    del w
    old = st.open_store(p)
    assert old.manifest.seq == s0.manifest.seq and np.array_equal(old.read_dense(), base)
    w2 = st.StoreWriter.open_for_append(p)
    assert not os.path.exists(orphan)
    extra = _rand_dense(10, 16, seed=7)
    w2.append_dense(extra)
    assert np.array_equal(w2.close().read_dense(), np.concatenate([base, extra]))


def test_open_for_append_rejects_shape_mismatch_and_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        st.StoreWriter.open_for_append(str(tmp_path / "nope"))
    p = str(tmp_path / "db")
    st.ingest_dense(_rand_dense(10, 16, seed=8), p, shard_rows=8)
    w = st.StoreWriter.open_for_append(p)
    with pytest.raises(ValueError):
        w.append_dense(_rand_dense(4, 17, seed=9))


def test_append_preserves_count_cache_section(tmp_path):
    p = str(tmp_path / "db")
    s0 = st.ingest_dense(_rand_dense(40, 16, seed=10), p, shard_rows=16)
    meta = {"version": 1, "seq": 1, "file": "count_cache_00000001.npz", "min_support": 0.1,
            "max_k": 3, "n": 40, "store": {"shard_rows": list(s0.manifest.shard_rows)}, "levels": []}
    np.savez(os.path.join(p, meta["file"]))
    s0.set_count_cache(meta)
    assert jst.open_store(p).count_cache_meta == meta   # the JAX package reads the section
    s1 = st.append_chunks([_rand_dense(8, 16, seed=11)], p)
    assert s1.count_cache_meta == meta
    s1.set_count_cache(None)
    assert st.open_store(p).count_cache_meta is None
    assert not os.path.exists(os.path.join(p, meta["file"]))
