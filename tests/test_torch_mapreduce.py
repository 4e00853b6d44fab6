"""PyTorch port: the Map/Reduce engine over a ``torch.distributed`` mesh and
shard-count invariance of the mesh mine (mirrors ``tests/test_mapreduce.py``).

The JAX tests fake several devices in one process; the port runs one
process a rank, spawned on the CPU over gloo (``launch.mesh.spawn``, rank
functions in ``torch_mesh_ranks.py``).  Every spawn has a deadline well
under 120 s.  The mesh mines must be dict-identical to the JAX package's
single-device ``mine`` and to the port's ``mesh=None``; the mine CLI on a
mesh prints the JAX CLI's last line; a rank that raises, hangs or dies fails
the spawn within its deadline and leaves no process behind.  The 2-D
count step's only collective is an all-reduce of the rank's Kp/M block on
its data group, as the JAX package's step with ``out_specs=P("model")``
sends; the level loop assembles the blocks.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from conftest import REPO_ROOT, subprocess_env  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core.mapreduce import pad_rows_to_shards as jpad  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import son as tson  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.core.mapreduce import pad_rows_to_shards  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, RankFailed, rank_device, spawn  # noqa: E402

DEADLINE_S = 60.0


def _spawn(fn, shape, axes, *args, timeout_s=DEADLINE_S):
    return spawn(fn, shape, axes, device="cpu", backend="gloo", timeout_s=timeout_s, args=args)


@pytest.fixture(scope="module")
def quest_db():
    """The JAX invariance test's DB and its single-device JAX mine."""
    db = gen_transactions(QuestConfig(num_transactions=333, num_items=48, avg_len=8, seed=11))
    want = japr.mine(db, japr.AprioriConfig(min_support=0.06, max_k=5, count_impl="jnp")).as_dict()
    return db, want


def _cfgs(**axes):
    return [AprioriConfig(min_support=0.06, max_k=5, representation=rep, **axes)
            for rep in ("dense", "packed")]


def test_mapreduce_single_rank_sum_max_min():
    (got,) = _spawn(ranks.reduce_ops, (1,), ("data",))
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(got["sum"], x.sum(0))
    np.testing.assert_array_equal(got["max"], x.max(0))
    np.testing.assert_array_equal(got["min"], x.min(0))


def test_pad_rows_to_shards_matches_jax():
    x = np.ones((5, 3), np.int8)
    padded, n = pad_rows_to_shards(x, 4)
    assert padded.shape == (8, 3) and n == 5 and padded[5:].sum() == 0
    np.testing.assert_array_equal(padded, jpad(x, 4)[0])
    same, _ = pad_rows_to_shards(x, 5)
    assert same.shape == (5, 3)


def test_hierarchical_psum_on_4_ranks():
    """Inner sum over "data", outer over "pod", with and without the outer
    hop's transform; every rank holds the whole sum."""
    got = _spawn(ranks.hierarchical, (2, 2), ("pod", "data"))
    base = np.arange(6, dtype=np.int32)
    for rank, out in enumerate(got):
        np.testing.assert_array_equal(out["plain"], base * 10)
        np.testing.assert_array_equal(out["narrowed"], base * 10)
        assert out["narrowed_dtype"] == "torch.int32" and out["calls"] == ["encode", "decode"]
        pod = rank // 2   # rank = pod * 2 + data: the inner sum adds the two data ranks of a pod
        np.testing.assert_array_equal(out["inner"], base * (2 * pod + 1 + 2 * pod + 2))
        np.testing.assert_array_equal(out["max"], base * 4)


@pytest.mark.parametrize("shape,axes,data_axes", [
    ((4, 2), ("data", "model"), ("data",)),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
])
def test_shard_count_invariance(quest_db, shape, axes, data_axes):
    """1 node == 4 x 2 == 2 x 2 x 2 (pod and data both split rows), 8 ranks,
    both representations: dict-identical to the JAX single-device mine and
    to the port's ``mesh=None``."""
    db, want = quest_db
    cfgs = _cfgs(data_axes=data_axes, model_axis="model")
    for cfg in cfgs:
        assert mine(db, cfg, device="cpu").as_dict() == want
    for per_rank in _spawn(ranks.mine_dicts, shape, axes, db, cfgs):
        assert per_rank == [want, want]


def test_paper_1d_layout_and_son(quest_db):
    """The paper's 1-D layout: (4, 1) with both axes splitting rows and no
    candidate split; and SON over 8 partitions dealt over the 4 ranks."""
    db, want = quest_db
    cfgs = _cfgs(data_axes=("data", "model"), model_axis=None)
    son_want = japr.mine(db, japr.AprioriConfig(min_support=0.06, max_k=5, count_impl="jnp")).as_dict()
    assert tson.mine_son(db, cfgs[0], device="cpu").as_dict() == son_want
    for got in _spawn(ranks.mine_dicts, (4, 1), ("data", "model"), db, cfgs):
        assert got == [want, want]
    for got in _spawn(ranks.son_dicts, (4, 1), ("data", "model"), db, cfgs, 8):
        assert got == [son_want, son_want]


@pytest.mark.parametrize("how,error,deadline_s", [("raise", ValueError, DEADLINE_S),
                                                  ("exit", RankFailed, DEADLINE_S),
                                                  ("exit_late", RankFailed, DEADLINE_S),
                                                  ("hang", TimeoutError, 15.0)])
def test_failing_rank_fails_spawn_and_leaves_no_process(tmp_path, how, error, deadline_s):
    """A rank that raises (its own error comes back), dies without a Python
    error, or hangs makes the spawn raise within its deadline, and every
    rank's process is gone afterwards.  A silent death is named even when a
    peer's error reaches the parent before the dead rank's exit code does
    (``exit_late``; under load a lost-connection error often does)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(error):
        _spawn(ranks.fail, (2,), ("data",), how, str(tmp_path), timeout_s=deadline_s)
    assert time.monotonic() - t0 < deadline_s + 15
    pids = [int((tmp_path / name).read_text()) for name in os.listdir(tmp_path)]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_chunk_iterator_keeps_this_ranks_rows():
    chunks = [np.arange(24, dtype=np.int32).reshape(6, 4) + 100 * i for i in range(3)]
    got = _spawn(ranks.row_blocks, (3,), ("data",), chunks)
    for rank, blocks in enumerate(got):
        for block, chunk in zip(blocks, chunks):
            np.testing.assert_array_equal(block, chunk[2 * rank : 2 * rank + 2])


def test_backend_and_device_are_checked():
    """The mesh picks no backend and refuses NCCL where it cannot run."""
    with pytest.raises(ValueError, match="nccl"):
        rank_device("cpu", "nccl", 0, 1)
    assert rank_device("cpu", "gloo", 3, 4) == torch.device("cpu")
    with pytest.raises(ValueError, match="backend"):
        spawn(ranks.reduce_ops, (1,), ("data",), device="cpu", backend="mpi")


CLI_ARGS = ["--transactions", "1500", "--items", "48", "--min-support", "0.03", "--max-k", "4", "--seed", "3"]


def _last_json(out):
    line = json.loads(out.strip().splitlines()[-1])
    line.pop("seconds")
    return line


def _cli(module, *extra):
    proc = subprocess.run([sys.executable, "-m", module, *CLI_ARGS, *extra], capture_output=True,
                          text=True, timeout=120, env=subprocess_env(), cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_mine_cli_on_a_mesh_prints_the_jax_line(capsys, tmp_path):
    """``--host-devices 4 --mesh 2x2 --device cpu`` prints the same last line,
    timings aside, as the port's CLI without a mesh and the JAX CLI with
    ``--host-devices 4 --mesh 2x2``, in memory and from a store that rank 0
    ingests; only rank 0 prints."""
    from repro_torch.launch import mine as tcli

    want = _last_json(_cli("repro.launch.mine", "--host-devices", "4", "--mesh", "2x2"))
    tcli.main([*CLI_ARGS, "--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == want
    out = _cli("repro_torch.launch.mine", "--host-devices", "4", "--mesh", "2x2", "--device", "cpu",
               "--representation", "packed")
    assert _last_json(out) == want and want["total_frequent"] > 0
    assert sum(line.startswith("[mine] generating") for line in out.splitlines()) == 1
    store = ["--store", str(tmp_path / "st"), "--ingest", "--stream-chunk-rows", "500", "--shard-rows", "700"]
    out = _cli("repro_torch.launch.mine", "--host-devices", "4", "--mesh", "2x2", "--device", "cpu", *store)
    assert _last_json(out) == want
    assert sum(line.startswith("[mine] ingesting") for line in out.splitlines()) == 1


def _init_names(path):
    """The names a package's ``__init__`` imports from its submodules."""
    import ast

    tree = ast.parse(open(path).read())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names}


def test_core_reexports_what_the_jax_core_does_without_cuda_state():
    """``repro_torch.core`` re-exports ``repro.core``'s names (the engine
    among them); importing it touches no CUDA state; and no module imports
    by name a submodule that a re-export hides (``mapreduce`` is the
    engine's function there, as in the JAX package)."""
    import re

    import repro_torch.core as tcore

    jnames = _init_names(os.path.join(REPO_ROOT, "src", "repro", "core", "__init__.py"))
    assert _init_names(tcore.__file__) == jnames
    assert tcore.mapreduce.__module__ == "repro_torch.core.mapreduce" and callable(tcore.MapReduceJob)
    code = ("import torch\n"
            "def refuse(*a, **k): raise AssertionError('CUDA state was touched')\n"
            "torch.cuda._lazy_init = refuse\ntorch.cuda.Stream = refuse\n"
            "import repro_torch.core, repro_torch.launch.mesh, repro_torch.serving\n"
            "assert not torch.cuda.is_initialized()\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          env=subprocess_env(), cwd=REPO_ROOT)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
    shadowed = {n for n in jnames if os.path.exists(os.path.join(os.path.dirname(tcore.__file__), n + ".py"))}
    assert shadowed == {"mapreduce"}
    pattern = re.compile(r"from repro_torch\.core import .*\b(%s)\b|import repro_torch\.core\.(%s) as"
                         % ("|".join(shadowed), "|".join(shadowed)))
    for root, _, files in os.walk(os.path.join(REPO_ROOT, "src", "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(root, name)).read()
                assert not pattern.search(text), f"{name} imports a shadowed submodule by name"


def test_2d_count_step_reduces_its_block_over_the_data_group_only(quest_db):
    """On a (2, 2) mesh split over ``model_axis`` the step sends one
    all-reduce of Kp/2 int32 on its data group ((0, 2) or (1, 3)) and
    returns its model block of the counts; ``_count_level`` still returns
    every count on every rank, equal to the single device's."""
    from repro_torch.core import apriori
    from repro_torch.core.candidates import generate_candidates

    db, _ = quest_db
    cfg = AprioriConfig(representation="packed")
    cands = generate_candidates(np.arange(db.shape[1], dtype=np.int32)[:, None])
    mesh_cfg = AprioriConfig(representation="packed", model_axis="model")
    kp = apriori._pad_bucket(cands.shape[0], apriori._candidate_quantum(mesh_cfg, MeshLayout((2, 2), ("data", "model"))))
    t = apriori.place_db(db, cfg, "cpu")
    c, ln = apriori._place_candidates(cands, kp, db.shape[1], cfg, "cpu")
    whole = apriori.make_count_step(cfg)(t, c, ln).numpy()
    assert kp % 2 == 0 and kp > cands.shape[0]
    for rank, got in enumerate(_spawn(ranks.count_step_collectives, (2, 2), ("data", "model"), db, kp)):
        m = got["model"]
        assert got["step_sent"] == [(kp // 2, (m, m + 2))]
        np.testing.assert_array_equal(got["block"], whole[m * kp // 2 : (m + 1) * kp // 2])
        np.testing.assert_array_equal(got["counts"], whole[: cands.shape[0]])
