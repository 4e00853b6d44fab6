"""PyTorch port: incremental delta mining on the CPU, held against the JAX
package's ``mine_delta`` and against a full re-mine.

Mirrors ``tests/test_incremental.py``: count-cache persistence, the
delta == full-re-mine property in both representations and at three
append sizes, minsup crossings both ways with the novel-candidate
re-verify, the ``noop`` and fallback modes, the checkpoint story (a
pre-append full-mine checkpoint is rejected, the delta path accepts the
grown store) and a crash resumed at each phase.  The count cache is the
JAX package's format byte for byte, so a cache written by either package
is delta-mined by the other with dict-identical results.
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.core import apriori as jap  # noqa: E402
from repro.core import incremental as jinc  # noqa: E402
from repro.data import store as jds  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as ap  # noqa: E402
from repro_torch.core import incremental as inc  # noqa: E402
from repro_torch.core import son as son_mod  # noqa: E402
from repro_torch.core import streaming as stm  # noqa: E402
from repro_torch.data import store as ds  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    CheckpointMismatch,
    MiningCheckpoint,
    MiningState,
    mining_fingerprint,
    store_fingerprint,
)

CFG = ap.AprioriConfig(min_support=0.02, max_k=3)
DEV = "cpu"


def _jcfg(cfg):
    """The same mine in the JAX package, on its jnp path."""
    return jap.AprioriConfig(min_support=cfg.min_support, max_k=cfg.max_k, count_impl="jnp",
                             representation=cfg.representation)


def _quest(n, seed, items=48):
    return gen_transactions(QuestConfig(num_transactions=n, num_items=items, seed=seed))


def _mine(dense, cfg):
    return ap.mine(dense, cfg, device=DEV).as_dict()


def _grown(tmp_path, base, extra, shard_rows=256, cfg=CFG, chunk_rows=300, name="db", jax_cache=False):
    """Ingest base, build the cache (by the port, or by the JAX package),
    append extra; returns (path, grown)."""
    p = str(tmp_path / name)
    s = ds.ingest_dense(base, p, shard_rows=shard_rows)
    if jax_cache:
        jinc.build_count_cache(jds.open_store(p), _jcfg(cfg), chunk_rows=chunk_rows)
    else:
        inc.build_count_cache(s, cfg, DEV, chunk_rows=chunk_rows)
    if len(extra):
        ds.append_chunks([extra], p)
    return p, np.concatenate([base, extra]) if len(extra) else base


def _same_cache(a, b):
    assert (a.seq, a.min_support, a.max_k, a.n, a.store_fp) == (b.seq, b.min_support, b.max_k, b.n, b.store_fp)
    assert sorted(a.levels) == sorted(b.levels)
    for k in a.levels:
        for x, y in zip(a.levels[k], b.levels[k]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


# ------------------------------------------------------------- persistence ----
def test_build_count_cache_persists_full_union_byte_equal_to_jax(tmp_path):
    base = _quest(1000, seed=1)
    p, pj = str(tmp_path / "db"), str(tmp_path / "jdb")
    s = ds.ingest_dense(base, p, shard_rows=256)
    js = jds.ingest_dense(base, pj, shard_rows=256)
    res, cache = inc.build_count_cache(s, CFG, DEV, chunk_rows=300)
    jres, jcache = jinc.build_count_cache(js, _jcfg(CFG), chunk_rows=300)
    assert res.as_dict() == _mine(base, CFG) == jres.as_dict()
    _same_cache(cache, jcache)
    # the sidecar and the manifest's section are the JAX package's bytes
    fname = inc.cache_filename(cache.seq)
    assert open(os.path.join(p, fname), "rb").read() == open(os.path.join(pj, fname), "rb").read()
    assert ds.open_store(p).count_cache_meta == jds.open_store(pj).count_cache_meta
    loaded = inc.load_count_cache(ds.open_store(p))
    assert loaded is not None and loaded.seq == cache.seq == 1
    assert loaded.store_fp == store_fingerprint(s)
    _same_cache(loaded, cache)
    # the cache is the PRE-prune union: counts below min_count are kept too
    assert any((cnt < res.min_count).any() for _, cnt in cache.levels.values())
    # rebuilding bumps the seq and GCs the superseded sidecar
    _, cache2 = inc.build_count_cache(ds.open_store(p), CFG, DEV, chunk_rows=300)
    assert cache2.seq == 2
    assert not os.path.exists(os.path.join(p, inc.cache_filename(1)))
    assert os.path.exists(os.path.join(p, inc.cache_filename(2)))


def test_load_count_cache_absent_or_stale(tmp_path):
    p = str(tmp_path / "db")
    s = ds.ingest_dense(_quest(200, seed=2), p, shard_rows=64)
    assert inc.load_count_cache(s) is None
    _, cache = inc.build_count_cache(s, CFG, DEV, chunk_rows=128)
    os.remove(os.path.join(p, inc.cache_filename(cache.seq)))
    assert inc.load_count_cache(ds.open_store(p)) is None


def test_entry_points_need_cuda_or_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    s = ds.ingest_dense(_quest(200, seed=2), str(tmp_path / "db"), shard_rows=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        inc.build_count_cache(s, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        inc.mine_delta(s, CFG)


# ----------------------------------------------------- the equivalence property ----
BASE_N = 2000


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """One base store with its count cache, written once by each package:
    ``{"port": dir, "jax": dir}``.  The cache holds exact counts, the same
    in either representation, so both representations' tests fold into
    it.  Tests copy a directory before they append to it."""
    root = tmp_path_factory.mktemp("seeded")
    base = _quest(BASE_N, seed=3)
    cfg = dataclasses.replace(CFG, representation="packed")
    dirs = {writer: _grown(root, base, base[:0], cfg=cfg, name=writer, jax_cache=(writer == "jax"))[0]
            for writer in ("port", "jax")}
    return base, dirs


def _copy(src, tmp_path, name):
    import shutil

    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("representation", ["dense", "packed"])
@pytest.mark.parametrize("append_n", [40, 300, 900])
def test_delta_mine_dict_identical_to_jax_and_full_remine(tmp_path, seeded, representation, append_n):
    """After an append (one shard .. several, distribution-shifted so
    supports cross minsup both ways) the port's delta mine equals the JAX
    package's delta mine of the same grown store and a full streamed
    re-mine; the advanced caches are byte-equal and seed the next delta."""
    cfg = dataclasses.replace(CFG, representation=representation)
    base, dirs = seeded
    extra = _quest(append_n, seed=103)
    grown = np.concatenate([base, extra])
    p = _copy(dirs["port"], tmp_path, "db")
    pj = _copy(dirs["jax"], tmp_path, "jdb")
    ds.append_chunks([extra], p)
    jds.append_chunks([extra], pj)
    res, rep = inc.mine_delta(ds.open_store(p), cfg, DEV, chunk_rows=300)
    jres, jrep = jinc.mine_delta(jds.open_store(pj), _jcfg(cfg), chunk_rows=300)
    assert rep.mode == "delta" and dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    full = stm.mine_streamed(ds.ingest_dense(grown, str(tmp_path / "ref"), shard_rows=256), cfg,
                             device=DEV, chunk_rows=300)
    assert res.as_dict() == jres.as_dict() == full.as_dict()
    assert res.min_count == full.min_count and res.num_transactions == len(grown)
    _same_cache(inc.load_count_cache(ds.open_store(p)), jinc.load_count_cache(jds.open_store(pj)))
    # the advanced cache seeds the NEXT delta: append again and re-check
    extra2 = _quest(200, seed=7)
    ds.append_chunks([extra2], p)
    res2, rep2 = inc.mine_delta(ds.open_store(p), cfg, DEV, chunk_rows=300)
    assert rep2.mode == "delta"
    assert res2.as_dict() == _mine(np.concatenate([grown, extra2]), cfg)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_count_cache_read_across_packages(tmp_path, seeded, writer):
    """A cache written by one package, the rows appended, then delta-mined
    by the other: dict-identical to a re-mine, and the advanced cache is
    the one the writer's own delta leaves."""
    cfg = dataclasses.replace(CFG, representation="packed")
    base, dirs = seeded
    extra = _quest(300, seed=22)
    grown = np.concatenate([base, extra])
    p = _copy(dirs[writer], tmp_path, "db")
    ds.append_chunks([extra], p)
    if writer == "jax":
        res, rep = inc.mine_delta(ds.open_store(p), cfg, DEV, chunk_rows=300)
    else:
        res, rep = jinc.mine_delta(jds.open_store(p), _jcfg(cfg), chunk_rows=300)
    assert rep.mode == "delta"
    assert res.as_dict() == _mine(grown, cfg)
    own = _copy(dirs[writer], tmp_path, "own")
    ds.append_chunks([extra], own)
    if writer == "jax":
        jinc.mine_delta(jds.open_store(own), _jcfg(cfg), chunk_rows=300)
    else:
        inc.mine_delta(ds.open_store(own), cfg, DEV, chunk_rows=300)
    _same_cache(inc.load_count_cache(ds.open_store(p)), inc.load_count_cache(ds.open_store(own)))


def test_delta_crossings_both_directions_and_novel_reverify(tmp_path):
    """Itemset A is frequent in the base and falls below minsup after the
    append; B is infrequent in the base (NOT in the one-partition cache
    union) and crosses above, forcing the re-verify pass over the base."""
    rng = np.random.default_rng(0)
    n_base, items = 200, 16
    base = (rng.random((n_base, items)) < 0.05).astype(np.int8)
    base[:, :4] = 0
    base[:21, [0, 1]] = 1        # A = {0,1}: 21 >= ceil(0.1*200) = 20
    base[30:49, [2, 3]] = 1      # B = {2,3}: 19 < 20 -> NOT in the union
    extra = (rng.random((40, items)) < 0.05).astype(np.int8)
    extra[:, :4] = 0
    extra[:30, [2, 3]] = 1       # B gains 30
    grown = np.concatenate([base, extra])
    for representation in ("dense", "packed"):
        cfg = ap.AprioriConfig(min_support=0.1, max_k=2, representation=representation)
        p = str(tmp_path / representation)
        s = ds.ingest_dense(base, p, shard_rows=1000)   # ONE base partition
        _, cache = inc.build_count_cache(s, cfg, DEV, chunk_rows=64)
        assert (0, 1) in inc.result_from_cache(cache, 20).as_dict()
        assert (2, 3) not in son_mod.arrays_to_winners(
            {k: c for k, (c, _) in cache.levels.items()}).get(2, set())
        ds.append_chunks([extra], p)
        res, rep = inc.mine_delta(ds.open_store(p), cfg, DEV, chunk_rows=64, max_drift_fraction=1.0)
        got = res.as_dict()
        # grown: n=240, min_count=24; A: 21 < 24 (crossed down), B: 49 >= 24 (up)
        assert (0, 1) not in got and got[(2, 3)] == 49
        assert rep.novel_candidates > 0, "B must have gone through the re-verify pass"
        assert got == _mine(grown, cfg) == jap.mine(grown, _jcfg(cfg)).as_dict()


def test_delta_noop_without_new_shards(tmp_path):
    p, grown = _grown(tmp_path, _quest(800, seed=4), np.zeros((0, 48), np.int8))
    pj, _ = _grown(tmp_path, _quest(800, seed=4), np.zeros((0, 48), np.int8), name="jdb", jax_cache=True)
    res, rep = inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300)
    jres, jrep = jinc.mine_delta(jds.open_store(pj), _jcfg(CFG), chunk_rows=300)
    assert rep.mode == "noop" and rep.delta_rows == 0
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert res.as_dict() == jres.as_dict() == _mine(grown, CFG)


# ---------------------------------------------------------------- fallbacks ----
def test_delta_fallback_reasons(tmp_path):
    base = _quest(1000, seed=5)
    p, _ = _grown(tmp_path, base, _quest(100, seed=6))
    other = dataclasses.replace(CFG, min_support=0.05)
    res, rep = inc.mine_delta(ds.open_store(p), other, DEV, chunk_rows=300)
    assert (rep.mode, rep.reason) == ("full", "config_changed")
    assert res.as_dict() == _mine(np.concatenate([base, _quest(100, seed=6)]), other)
    p2 = str(tmp_path / "db2")
    ds.ingest_dense(base, p2, shard_rows=256)
    _, rep2 = inc.mine_delta(ds.open_store(p2), CFG, DEV, chunk_rows=300)
    assert (rep2.mode, rep2.reason) == ("full", "no_cache")
    ds.append_chunks([_quest(1500, seed=8)], p2)
    res3, rep3 = inc.mine_delta(ds.open_store(p2), CFG, DEV, chunk_rows=300)
    assert (rep3.mode, rep3.reason) == ("full", "delta_fraction")
    assert res3.as_dict() == _mine(np.concatenate([base, _quest(1500, seed=8)]), CFG)


def test_delta_fallback_on_base_mutation_and_drift(tmp_path):
    base = _quest(600, seed=9, items=24)
    p, _ = _grown(tmp_path, base, np.zeros((0, 24), np.int8), shard_rows=128)
    meta = ds.open_store(p).count_cache_meta
    ds.ingest_dense(_quest(600, seed=10, items=24), p, shard_rows=100)
    s = ds.open_store(p)
    s.set_count_cache(meta)   # graft the stale section back on
    assert inc.cache_invalid_reason(s, inc.load_count_cache(s), CFG) == "base_mutated"
    # vocabulary drift: the append lights up items the base never had
    rng = np.random.default_rng(1)
    narrow = np.zeros((400, 24), np.int8)
    narrow[:, :4] = (rng.random((400, 4)) < 0.5).astype(np.int8)
    wide = (rng.random((120, 24)) < 0.5).astype(np.int8)   # all 24 items hot
    p2 = str(tmp_path / "db2")
    inc.build_count_cache(ds.ingest_dense(narrow, p2, shard_rows=128), CFG, DEV, chunk_rows=128)
    ds.append_chunks([wide], p2)
    pj = str(tmp_path / "jdb2")
    jinc.build_count_cache(jds.ingest_dense(narrow, pj, shard_rows=128), _jcfg(CFG), chunk_rows=128)
    jds.append_chunks([wide], pj)
    res, rep = inc.mine_delta(ds.open_store(p2), CFG, DEV, chunk_rows=128)
    jres, jrep = jinc.mine_delta(jds.open_store(pj), _jcfg(CFG), chunk_rows=128)
    assert (rep.mode, rep.reason) == (jrep.mode, jrep.reason) == ("full", "vocabulary_drift")
    assert res.as_dict() == jres.as_dict() == _mine(np.concatenate([narrow, wide]), CFG)


# ------------------------------------------ checkpoints vs appended shards ----
def test_full_mine_checkpoint_rejected_after_append_but_delta_accepts(tmp_path):
    base = _quest(1200, seed=11)
    p = str(tmp_path / "db")
    s = ds.ingest_dense(base, p, shard_rows=256)
    inc.build_count_cache(s, CFG, DEV, chunk_rows=300)
    mgr = MiningCheckpoint(str(tmp_path / "ck"))
    mgr.save(MiningState(levels={}, next_k=2), store_fingerprint(s), mining_fingerprint(CFG, 300))
    mgr.wait()
    grown = ds.append_chunks([_quest(150, seed=12)], p)
    _, manifest = mgr.load_latest()
    with pytest.raises(CheckpointMismatch):
        mgr.validate(manifest, store_fingerprint(grown), mining_fingerprint(CFG, 300))
    with pytest.raises(CheckpointMismatch):
        stm.mine_streamed(grown, CFG, device=DEV, chunk_rows=300, checkpoint=mgr, resume=True)
    cache = inc.load_count_cache(grown)
    assert inc.cache_invalid_reason(grown, cache, CFG) is None
    assert store_fingerprint(grown, cache.num_shards) == cache.store_fp
    res, rep = inc.mine_delta(grown, CFG, DEV, chunk_rows=300)
    assert rep.mode == "delta"
    assert res.as_dict() == _mine(np.concatenate([base, _quest(150, seed=12)]), CFG)


class _Crash(BaseException):
    """Out-of-band interrupt no library code catches."""


def test_delta_crash_resume_skips_phase1(tmp_path, monkeypatch):
    """Crash after the phase-1 snapshot: the resumed delta mine restores the
    appended-shard winners from the checkpoint (phase 1 is NOT re-run) and
    still matches the full re-mine."""
    base, extra = _quest(2000, seed=13), _quest(300, seed=14)
    p, grown = _grown(tmp_path, base, extra)
    real_count = stm.count_union_streamed

    def boom(*a, **kw):
        raise _Crash()

    monkeypatch.setattr(inc.st, "count_union_streamed", boom)
    with pytest.raises(_Crash):
        inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300, checkpoint=True)
    monkeypatch.setattr(inc.st, "count_union_streamed", real_count)

    def no_phase1(*a, **kw):
        raise AssertionError("phase 1 must be restored from the checkpoint")

    monkeypatch.setattr(inc.son_mod, "union_local_winners", no_phase1)
    res, rep = inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300, checkpoint=True, resume=True)
    monkeypatch.undo()
    assert rep.mode == "delta" and rep.resumed_phase == inc._PHASE_WINNERS
    assert res.as_dict() == _mine(grown, CFG)
    assert MiningCheckpoint(os.path.join(ds.open_store(p).checkpoint_path, "delta")).load_latest() is None


def test_delta_crash_resume_after_delta_counts(tmp_path, monkeypatch):
    """Crash after the phase-2 snapshot: resume restores the union AND its
    delta counts, then only the base pass runs."""
    base, extra = _quest(2000, seed=15), _quest(300, seed=16)
    p, grown = _grown(tmp_path, base, extra)
    real_count = stm.count_union_streamed
    calls = {"n": 0}

    def crash_on_base_pass(store, per_level, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:      # 1st call = delta pass, 2nd = base re-verify
            raise _Crash()
        return real_count(store, per_level, *a, **kw)

    monkeypatch.setattr(inc.st, "count_union_streamed", crash_on_base_pass)
    with pytest.raises(_Crash):
        inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300, checkpoint=True)
    monkeypatch.undo()
    seen_shards = []

    def record(store, per_level, *a, **kw):
        seen_shards.append(kw.get("shards"))
        return real_count(store, per_level, *a, **kw)

    monkeypatch.setattr(inc.st, "count_union_streamed", record)
    res, rep = inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300, checkpoint=True, resume=True)
    monkeypatch.undo()
    assert rep.resumed_phase == inc._PHASE_DELTA_COUNTS
    assert all(s == (0, rep.base_shards) for s in seen_shards), seen_shards
    assert res.as_dict() == _mine(grown, CFG)


@pytest.mark.parametrize("phase", ["winners", "delta_counts"])
def test_delta_checkpoint_resumed_across_packages(tmp_path, seeded, monkeypatch, phase):
    """A delta snapshot the JAX package left at either phase is resumed by
    the port (the checkpoint format is shared): same result as the JAX
    package's full mine."""
    base, dirs = seeded
    extra = _quest(300, seed=20)
    grown = np.concatenate([base, extra])
    p = _copy(dirs["jax"], tmp_path, "db")
    ds.append_chunks([extra], p)
    real = jinc.st.count_union_streamed
    calls = {"n": 0}
    crash_at = 1 if phase == "winners" else 2

    def crash(store, per_level, *a, **kw):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise _Crash()
        return real(store, per_level, *a, **kw)

    monkeypatch.setattr(jinc.st, "count_union_streamed", crash)
    with pytest.raises(_Crash):
        jinc.mine_delta(jds.open_store(p), _jcfg(CFG), chunk_rows=300, checkpoint=True)
    monkeypatch.undo()
    res, rep = inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300, checkpoint=True, resume=True)
    want = {"winners": inc._PHASE_WINNERS, "delta_counts": inc._PHASE_DELTA_COUNTS}[phase]
    assert rep.mode == "delta" and rep.resumed_phase == want
    assert res.as_dict() == jap.mine(grown, _jcfg(CFG)).as_dict()


def test_delta_checkpoint_rejects_foreign_cache_generation(tmp_path):
    base = _quest(1000, seed=17)
    p, _ = _grown(tmp_path, base, _quest(100, seed=18))
    store = ds.open_store(p)
    cache = inc.load_count_cache(store)
    sfp, mfp = inc.delta_fingerprints(store, cache, CFG, 300)
    mgr = inc._delta_manager(True, store)
    mgr.save(MiningState(levels={}, next_k=inc._PHASE_WINNERS), sfp, mfp)
    mgr.wait()
    _, manifest = mgr.load_latest()
    stale = dataclasses.replace(cache, seq=cache.seq + 1)
    sfp2, mfp2 = inc.delta_fingerprints(store, stale, CFG, 300)
    with pytest.raises(CheckpointMismatch):
        mgr.validate(manifest, sfp2, mfp2)


def test_delta_with_fault_config_matches(tmp_path):
    """Phase 1 of the delta through the retrying executor (``fault=``):
    the mapper mines each appended shard on the caller's device."""
    from repro_torch.distributed.fault_tolerance import FaultConfig

    base, extra = _quest(1500, seed=23), _quest(600, seed=24)
    p, grown = _grown(tmp_path, base, extra)
    res, rep = inc.mine_delta(ds.open_store(p), CFG, DEV, chunk_rows=300,
                              fault=FaultConfig(max_retries=1, speculative=False))
    assert rep.mode == "delta" and rep.delta_shards == 3
    assert res.fault_report is not None and res.as_dict() == _mine(grown, CFG)
