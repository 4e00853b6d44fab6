"""PyTorch port: resumable streamed mining and the retrying SON executor on
the CPU (mirrors ``tests/test_mining_checkpoint.py`` and
``tests/test_fault_tolerance.py``).  The checkpoint manager roundtrips,
stays crash-consistent and refuses foreign snapshots; a mine stopped at
every level and chunk boundary of the reference's test resumes to the same
dict; a checkpoint written mid-level by either package resumes in the other;
a real ``kill -9`` resumes in a fresh process; the executor retries,
speculates, names and skips partitions as the JAX package's does."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from conftest import REPO_ROOT, subprocess_env  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.data import store as jst  # noqa: E402
from repro.distributed import checkpoint as jck  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.data import store as st  # noqa: E402
from repro_torch.distributed import checkpoint as tck  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    COMMITTED,
    CheckpointMismatch,
    MiningCheckpoint,
    MiningState,
    mining_fingerprint,
    store_fingerprint,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    FaultConfig,
    FaultReport,
    InjectedFailure,
    PartitionFailure,
    run_partitions,
)

CFG = AprioriConfig(min_support=0.05, max_k=4)


def _store(small_db, path, shard_rows=90):
    return st.ingest_dense(small_db, str(path), shard_rows=shard_rows)


def _fps(store, cfg=CFG, chunk_rows=64):
    return store_fingerprint(store), mining_fingerprint(cfg, chunk_rows)


# ------------------------------------------------------- manager mechanics --
def test_checkpoint_roundtrip_mid_level_and_format_equal_to_jax(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    sfp, mfp = _fps(s)
    jcfg = japr.AprioriConfig(min_support=0.05, max_k=4, count_impl="jnp")
    assert (sfp, mfp) == (jck.store_fingerprint(s), jck.mining_fingerprint(jcfg, 64))
    assert tck._CONFIG_FIELDS == jck._CONFIG_FIELDS and "count_impl" not in tck._CONFIG_FIELDS
    levels = {1: (np.arange(6, dtype=np.int32).reshape(6, 1), np.arange(6, dtype=np.int64) + 40)}
    state = MiningState(levels=levels, next_k=2, mid_level=True, pass_start=8, chunks_done=3,
                        counts=np.arange(20, dtype=np.int64), acc=np.arange(16, dtype=np.int32))
    mgr = MiningCheckpoint(str(tmp_path / "ck"))
    seq = mgr.save(state, sfp, mfp)
    mgr.wait()
    assert mgr.latest_seq() == seq
    for reader in (mgr, jck.MiningCheckpoint(mgr.path)):   # either package reads it
        got, manifest = reader.load_latest()
        reader.validate(manifest, sfp, mfp)
        assert (got.next_k, got.mid_level, got.pass_start, got.chunks_done) == (2, True, 8, 3)
        np.testing.assert_array_equal(got.counts, state.counts)
        np.testing.assert_array_equal(got.acc, state.acc)
        np.testing.assert_array_equal(got.levels[1][0], levels[1][0])
        np.testing.assert_array_equal(got.levels[1][1], levels[1][1])


def test_uncommitted_snapshot_is_invisible(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    sfp, mfp = _fps(s)
    mgr = MiningCheckpoint(str(tmp_path / "ck"))
    mgr.save(MiningState(levels={}, next_k=1), sfp, mfp)
    mgr.wait()
    good_seq = mgr.latest_seq()
    torn = os.path.join(mgr.path, f"ckpt_{good_seq + 1:08d}")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"version": 1}, f)
    assert not os.path.exists(os.path.join(torn, COMMITTED))
    assert mgr.latest_seq() == good_seq
    assert mgr.load_latest()[0].next_k == 1
    assert MiningCheckpoint(mgr.path).save(MiningState(levels={}, next_k=2), sfp, mfp) > good_seq + 1


def test_retention_keeps_newest_and_clear_drops_all(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    sfp, mfp = _fps(s)
    mgr = MiningCheckpoint(str(tmp_path / "ck"), keep=2)
    for k in range(1, 6):
        mgr.save(MiningState(levels={}, next_k=k), sfp, mfp)
    mgr.wait()
    assert len([d for d in os.listdir(mgr.path) if d.startswith("ckpt_")]) == 2
    assert mgr.load_latest()[0].next_k == 5
    mgr.clear()
    assert mgr.load_latest() is None
    with pytest.raises(ValueError):
        MiningCheckpoint(mgr.path, keep=0)


@pytest.mark.parametrize("what", ["store", "config", "chunk_rows"])
def test_validate_rejects_foreign_checkpoint(tmp_path, small_db, what):
    s = _store(small_db, tmp_path / "db")
    sfp, mfp = _fps(s)
    mgr = MiningCheckpoint(str(tmp_path / "ck"))
    mgr.save(MiningState(levels={}, next_k=2), sfp, mfp)
    mgr.wait()
    _, manifest = mgr.load_latest()
    if what == "store":
        sfp = store_fingerprint(_store(small_db[:200], tmp_path / "db2"))
    elif what == "config":
        mfp = mining_fingerprint(dataclasses.replace(CFG, min_support=0.1), 64)
    else:
        mfp = mining_fingerprint(CFG, 77)
    with pytest.raises(CheckpointMismatch):
        mgr.validate(manifest, sfp, mfp)


# ------------------------------------------------- in-process stop + resume --
class _Interrupt(BaseException):
    """Out-of-band stop that no library code catches."""


def _killing(base):
    class Killing(base):
        """Commits ``stop_after`` snapshots, then dies."""

        def __init__(self, path, stop_after):
            super().__init__(path)
            self.stop_after, self.saves = stop_after, 0

        def save(self, state, store_fp, mine_fp):
            seq = super().save(state, store_fp, mine_fp)
            self.saves += 1
            if self.saves >= self.stop_after:
                self.wait()
                raise _Interrupt()
            return seq

    return Killing


@pytest.mark.parametrize("rep", ["dense", "packed"])
@pytest.mark.parametrize("stop_after", [1, 2, 3, 5, 8])
def test_killed_and_resumed_mine_is_dict_identical(tmp_path, small_db, rep, stop_after):
    """Stopped at the Nth committed snapshot (mid-level cursors and level
    boundaries alike), resumed from disk: dict-identical to an uninterrupted
    mine and to the in-memory miner."""
    cfg = dataclasses.replace(CFG, representation=rep)
    s = _store(small_db, tmp_path / "db")
    want = streaming.mine_streamed(s, cfg, device="cpu", chunk_rows=64)
    assert want.as_dict() == mine(small_db, cfg, device="cpu").as_dict()
    ck = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        streaming.mine_streamed(s, cfg, device="cpu", chunk_rows=64,
                                checkpoint=_killing(MiningCheckpoint)(ck, stop_after), checkpoint_every_chunks=1)
    assert MiningCheckpoint(ck).load_latest() is not None
    got = streaming.mine_streamed(s, cfg, device="cpu", chunk_rows=64, checkpoint=MiningCheckpoint(ck),
                                  checkpoint_every_chunks=1, resume=True)
    assert got.as_dict() == want.as_dict() and got.min_count == want.min_count


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_checkpoint_written_by_either_package_resumes_in_the_other(tmp_path, small_db, writer, rep):
    """A mine stopped mid-level (third snapshot, in level 2) by one package
    resumes in the other to the same dict."""
    jcfg = japr.AprioriConfig(min_support=0.05, max_k=4, count_impl="jnp", representation=rep)
    tcfg = dataclasses.replace(CFG, representation=rep)
    s = _store(small_db, tmp_path / "db")
    js = jst.open_store(s.path)
    ck = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        if writer == "jax":
            jstream.mine_streamed(js, jcfg, chunk_rows=64, checkpoint=_killing(jck.MiningCheckpoint)(ck, 7),
                                  checkpoint_every_chunks=1)
        else:
            streaming.mine_streamed(s, tcfg, device="cpu", chunk_rows=64,
                                    checkpoint=_killing(MiningCheckpoint)(ck, 7), checkpoint_every_chunks=1)
    state, _ = MiningCheckpoint(ck).load_latest()
    assert state.mid_level and state.next_k == 2 and state.chunks_done > 0
    if writer == "jax":
        got = streaming.mine_streamed(s, tcfg, device="cpu", chunk_rows=64, checkpoint=MiningCheckpoint(ck),
                                      checkpoint_every_chunks=1, resume=True)
    else:
        got = jstream.mine_streamed(js, jcfg, chunk_rows=64, checkpoint=jck.MiningCheckpoint(ck),
                                    checkpoint_every_chunks=1, resume=True)
    assert got.as_dict() == mine(small_db, tcfg, device="cpu").as_dict()


def test_level_boundary_only_checkpoint_resumes(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    want = streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64)
    ck = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64, checkpoint=_killing(MiningCheckpoint)(ck, 2))
    state, _ = MiningCheckpoint(ck).load_latest()
    assert not state.mid_level and state.next_k == 3
    got = streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64, checkpoint=MiningCheckpoint(ck),
                                  resume=True)
    assert got.as_dict() == want.as_dict()


def test_resume_rejects_changed_chunking_and_needs_a_manager(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    ck = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64, checkpoint=_killing(MiningCheckpoint)(ck, 3),
                                checkpoint_every_chunks=1)
    with pytest.raises(CheckpointMismatch):
        streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=77, checkpoint=MiningCheckpoint(ck),
                                checkpoint_every_chunks=1, resume=True)
    with pytest.raises(ValueError, match="resume"):
        streaming.mine_streamed(s, CFG, device="cpu", resume=True)


def test_resume_with_empty_dir_mines_from_scratch(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    got = streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64, checkpoint=str(tmp_path / "ck"),
                                  resume=True)
    assert got.as_dict() == mine(small_db, CFG, device="cpu").as_dict()


def test_fresh_mine_clears_stale_snapshots(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    ck = str(tmp_path / "ck")
    stale = MiningCheckpoint(ck)
    stale.save(MiningState(levels={}, next_k=9), *_fps(s))
    stale.wait()
    streaming.mine_streamed(s, CFG, device="cpu", chunk_rows=64, checkpoint=ck)
    assert MiningCheckpoint(ck).load_latest()[0].next_k != 9


# ------------------------------------------------------ kill -9 subprocess --
_KILL9 = textwrap.dedent(
    """
    import json, os, signal, sys
    from repro_torch.core.apriori import AprioriConfig
    from repro_torch.core.streaming import mine_streamed
    from repro_torch.data.store import open_store
    from repro_torch.distributed.checkpoint import MiningCheckpoint

    mode, d = sys.argv[1], sys.argv[2]
    cfg = AprioriConfig(min_support=0.03, max_k=3, representation="packed")
    store = open_store(d)
    if mode == "kill":
        class Killing(MiningCheckpoint):
            def save(self, state, sfp, mfp):
                seq = super().save(state, sfp, mfp)
                if state.mid_level and state.next_k >= 2:
                    self.wait()
                    os.kill(os.getpid(), signal.SIGKILL)
                return seq
        mine_streamed(store, cfg, device="cpu", chunk_rows=128, checkpoint=Killing(store.checkpoint_path),
                      checkpoint_every_chunks=2)
        raise SystemExit("unreachable: SIGKILL must have fired")
    assert MiningCheckpoint(store.checkpoint_path).load_latest() is not None
    res = mine_streamed(store, cfg, device="cpu", chunk_rows=128, checkpoint=True,
                        checkpoint_every_chunks=2, resume=True)
    sig = {k: [v[0].tolist(), v[1].tolist()] for k, v in sorted(res.levels.items())}
    print("SIG", json.dumps(sig, sort_keys=True))
    """
)


def test_kill9_subprocess_resume_parity(tmp_path):
    """A real ``kill -9`` mid-level (no atexit, no finally) and a resume in a
    fresh process reproduce the uninterrupted mine exactly."""
    from repro_torch.data.synthetic import QuestConfig

    store = st.ingest_quest(QuestConfig(2000, 64, avg_len=9, seed=11), str(tmp_path / "db"), shard_rows=256)
    cfg = AprioriConfig(min_support=0.03, max_k=3, representation="packed")
    res = streaming.mine_streamed(store, cfg, device="cpu", chunk_rows=128)
    want = json.dumps({k: [v[0].tolist(), v[1].tolist()] for k, v in sorted(res.levels.items())},
                      sort_keys=True)

    def run(mode):
        return subprocess.run([sys.executable, "-c", _KILL9, mode, store.path], capture_output=True,
                              text=True, timeout=120, env=subprocess_env(), cwd=REPO_ROOT)

    killed = run("kill")
    assert killed.returncode == -signal.SIGKILL, (killed.returncode, killed.stderr[-2000:])
    assert "SIG" not in killed.stdout
    resumed = run("resume")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert resumed.stdout[resumed.stdout.index("SIG") + 4:].strip() == want


# ----------------------------------------------------------- the executor --
def _fail_at(*fail_attempts):
    def injector(partition, attempt):
        if (partition, attempt) in fail_attempts:
            raise InjectedFailure(f"injected loss of partition {partition}")

    return injector


def test_run_partitions_no_faults_and_empty():
    results, report = run_partitions(lambda p: p * p, 7, FaultConfig(max_workers=3))
    assert results == [p * p for p in range(7)]
    assert report.completed == 7 and report.retries == 0 and report.skipped == ()
    assert report.total_failures == 0 and report.attempts == {p: 1 for p in range(7)}
    results, report = run_partitions(lambda p: p, 0)
    assert results == [] and report.completed == 0


def test_retries_with_backoff_then_success():
    fault = FaultConfig(max_retries=2, backoff_s=0.001, failure_injector=_fail_at((2, 0), (2, 1), (4, 0)))
    results, report = run_partitions(lambda p: p + 100, 6, fault)
    assert results == [p + 100 for p in range(6)]
    assert report.retries == 3 and report.attempts[2] == 3 and report.attempts[4] == 2
    assert report.skipped == ()


def test_exhausted_raises_naming_partition():
    fault = FaultConfig(max_retries=1, backoff_s=0.001, failure_injector=_fail_at((3, 0), (3, 1)))
    with pytest.raises(PartitionFailure, match="partition 3") as ei:
        run_partitions(lambda p: p, 5, fault)
    assert ei.value.partition == 3 and ei.value.attempts == 2
    assert isinstance(ei.value.cause, InjectedFailure)


def test_skip_mode_records_explicit_gap():
    fault = FaultConfig(max_retries=1, backoff_s=0.001, on_exhausted="skip",
                        failure_injector=_fail_at((3, 0), (3, 1)))
    results, report = run_partitions(lambda p: p * 10, 5, fault)
    assert results[3] is None and [r for i, r in enumerate(results) if i != 3] == [0, 10, 20, 40]
    assert report.skipped == (3,) and report.total_failures >= 1


def test_worker_exception_is_retried_like_injection():
    calls = {}

    def flaky(p):
        calls[p] = calls.get(p, 0) + 1
        if p == 1 and calls[p] == 1:
            raise OSError("shard read failed")
        return p

    results, report = run_partitions(flaky, 4, FaultConfig(backoff_s=0.001))
    assert results == [0, 1, 2, 3] and report.retries == 1 and calls[1] == 2


def test_speculative_reissue_of_straggler():
    release = threading.Event()
    calls = {}
    lock = threading.Lock()

    def worker(p):
        with lock:
            calls[p] = calls.get(p, 0) + 1
            first = calls[p] == 1
        if p == 0 and first:
            release.wait(timeout=30)   # parked until its backup copy finishes
            time.sleep(0.2)
            return (p, "slow")
        if p == 0:
            release.set()
        return (p, "fast")

    results, report = run_partitions(worker, 4, FaultConfig(max_workers=2, speculative=True,
                                                            speculative_factor=2.0))
    assert report.speculative_issued >= 1 and calls[0] >= 2
    assert results[0] == (0, "fast") and [r[0] for r in results] == [0, 1, 2, 3]
    assert report.completed == 4


def test_fault_config_validation():
    for bad in (dict(max_retries=-1), dict(max_workers=0), dict(on_exhausted="explode")):
        with pytest.raises(ValueError):
            FaultConfig(**bad)
    j = FaultReport(attempts={0: 2}, retries=1, skipped=(3,)).to_json()
    assert j["attempts"] == {0: 2} and j["retries"] == 1 and j["skipped"] == [3]


# -------------------------------------------- mine_son_streamed through it --
def _son_store(small_db, path):
    return st.ingest_dense(small_db, str(path), shard_rows=80)


def test_son_injected_failures_same_itemsets(tmp_path, small_db):
    want = mine(small_db, CFG, device="cpu")
    s = _son_store(small_db, tmp_path / "db")
    assert s.num_partitions >= 4
    fault = FaultConfig(max_retries=2, backoff_s=0.001, max_workers=2,
                        failure_injector=_fail_at((0, 0), (0, 1), (3, 0)))
    got = streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64, fault=fault)
    assert got.as_dict() == want.as_dict()
    assert got.fault_report.retries == 3 and got.fault_report.skipped == ()
    assert got.fault_report.completed == s.num_partitions


def test_son_fault_free_executor_matches_plain(tmp_path, small_db):
    s = _son_store(small_db, tmp_path / "db")
    got = streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64, fault=FaultConfig(max_workers=3))
    assert got.as_dict() == mine(small_db, CFG, device="cpu").as_dict()
    assert got.fault_report.retries == 0
    assert got.fault_report.attempts == {p: 1 for p in range(s.num_partitions)}


def test_son_exhausted_retries_names_partition(tmp_path, small_db):
    s = _son_store(small_db, tmp_path / "db")
    fault = FaultConfig(max_retries=1, backoff_s=0.001, failure_injector=_fail_at((1, 0), (1, 1)))
    with pytest.raises(PartitionFailure, match="partition 1"):
        streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64, fault=fault)


def test_son_skip_mode_reports_gap_explicitly(tmp_path, small_db):
    s = _son_store(small_db, tmp_path / "db")
    fault = FaultConfig(max_retries=0, backoff_s=0.001, on_exhausted="skip", failure_injector=_fail_at((2, 0)))
    got = streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64, fault=fault)
    assert got.fault_report.skipped == (2,)
    want = mine(small_db, CFG, device="cpu").as_dict()
    got_d = got.as_dict()
    assert got_d and all(want[itemset] == sup for itemset, sup in got_d.items())


def test_son_shard_read_error_retried(tmp_path, small_db, monkeypatch):
    s = _son_store(small_db, tmp_path / "db")
    want = streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64)
    calls = {}
    orig = s.partition_dense

    def flaky(p):
        calls[p] = calls.get(p, 0) + 1
        if p == 2 and calls[p] == 1:
            raise OSError("shard 2 read failed")
        return orig(p)

    monkeypatch.setattr(s, "partition_dense", flaky)
    got = streaming.mine_son_streamed(s, CFG, device="cpu", chunk_rows=64,
                                      fault=FaultConfig(max_retries=2, backoff_s=0.001))
    assert got.as_dict() == want.as_dict() and got.fault_report.retries == 1 and calls[2] == 2
