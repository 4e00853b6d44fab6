"""PyTorch port: the replicated serving tier on a mesh — ``Router(mesh=)``
(F13) and ``RefreshController(mesh=)`` for a target that is not a mesh
gateway (F12) — over spawned CPU ranks (gloo), at the size of
``test_torch_mesh_gateway.py``: the 400 x 64 DB, its count cache, 40 rows
appended, a 2 x 2 ``("data", "model")`` mesh.

F13: every rank builds ``Router(rb, 2, mesh=mesh)``; each replica is a mesh
gateway on groups of its own (the second on ``Mesh.twin()``).  Rank 0 serves
90 baskets from 4 threads, kills replica 0's dispatch worker and swaps at
half load, then appends the rows and refreshes on every rank while it
serves: zero drops, every response bit for bit the mesh ``recommend`` of its
generation at its bucket (and within rtol 1e-5, atol 1e-6 of JAX's
``recommend(impl="jnp")``), the mine run once a cycle on every rank, each
replica placing its block of its own rank's rulebook, both replicas
committed to one generation, and no group used by two threads at once.

F12: rank 0's target serves on its one device (``Router(rb, 2)`` or
``Gateway(rb)``), the other ranks pass None, and the refresh mines on the
mesh: the generation moves on rank 0, a follower's ``refresh_now`` returns
it, a cycle that fails on one rank fails on every rank while the old
generation serves on, ``mode="full"`` mines the whole store, and
``close()`` during a cycle commits nothing and ends every rank's loop.

Each mined result is dict-identical to JAX's ``mine_delta`` (or, in full
mode, ``mine_streamed``).  The JAX package serves both combinations on 4
host devices; its tests run in a subprocess, since ``XLA_FLAGS`` must be set
before ``jax`` is imported.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from conftest import REPO_ROOT, subprocess_env  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core import incremental as jinc  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.data import store as jds  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.serving.recommend import recommend as jrecommend  # noqa: E402
from repro.serving.rulebook import compile_rulebook as jcompile  # noqa: E402
from repro_torch.core import incremental as inc  # noqa: E402
from repro_torch.core.apriori import AprioriConfig  # noqa: E402
from repro_torch.data.store import open_store  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.serving.rulebook import rulebook_from_arrays  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
TOP_K, MAX_BATCH, CLIENTS = 5, 16, 4
DEADLINE_S = 90.0
JCFG = japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp", representation="packed")
CFG = AprioriConfig(min_support=0.04, max_k=4, representation="packed", data_axes=("data",),
                    model_axis="model")


def _spawn(fn, *args):
    return spawn(fn, (2, 2), ("data", "model"), device="cpu", backend="gloo", timeout_s=DEADLINE_S, args=args)


def _port(jrb):
    return rulebook_from_arrays(jrb.ante_packed, jrb.cons_packed, jrb.ante_len, jrb.scores, jrb.num_items,
                                jrb.score_kind, jrb.min_confidence)


def _held(items, scores, want_items, want_scores):
    """Scores within tolerance; items equal wherever the reference's scores
    are apart by more than the tolerance (a tie may order either way)."""
    np.testing.assert_allclose(scores, want_scores, rtol=RTOL, atol=ATOL)
    s = np.asarray(want_scores)
    tie = np.abs(np.diff(s, axis=-1)) <= ATOL + RTOL * np.abs(s[..., 1:])
    close = np.zeros_like(s, dtype=bool)
    close[..., 1:] |= tie
    close[..., :-1] |= tie
    np.testing.assert_array_equal(np.asarray(items)[~close], np.asarray(want_items)[~close])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The DB and rulebooks of ``test_torch_mesh_gateway.py`` (gen 0 at
    min_support 0.04, the swap's at 0.06), a store of the DB with its count
    cache (F13 appends the rows itself), four copies of it with the 40 rows
    appended (F12), and the references: JAX's ``mine_delta`` and
    ``mine_streamed`` of the grown store, and the rulebook compiled from
    the first."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    res1 = japr.mine(db, japr.AprioriConfig(min_support=0.06, max_k=4, count_impl="jnp"))
    jrb0 = jcompile(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    jrb1 = jcompile(res1, min_confidence=0.5, num_items=64, pad_multiple=8)
    root = tmp_path_factory.mktemp("mesh-router")
    store, jax_store = str(root / "store"), str(root / "jax-store")
    jds.ingest_dense(db, store, shard_rows=100)
    shutil.copytree(store, jax_store)
    inc.build_count_cache(open_store(store), CFG, "cpu", chunk_rows=64)
    jinc.build_count_cache(jds.open_store(jax_store), JCFG, chunk_rows=64)
    grown = str(root / "grown")
    shutil.copytree(store, grown)
    for path in (grown, jax_store):
        jds.append_chunks([extra], path)
    stores = {}
    for name in ("router", "gateway", "full", "close"):
        stores[name] = str(root / f"single-{name}")
        shutil.copytree(grown, stores[name])
    jfull = jst.mine_streamed(jds.open_store(jax_store), JCFG, chunk_rows=64)
    jres2, jrep2 = jinc.mine_delta(jds.open_store(jax_store), JCFG, chunk_rows=64)
    assert jrep2.mode == "delta"
    jrb2 = jcompile(jres2, min_confidence=0.4, num_items=64)
    return dict(db=db, extra=extra, baskets=db[:90], jrb={0: jrb0, 1: jrb1, 2: jrb2},
                rb={0: _port(jrb0), 1: _port(jrb1)}, store=store, stores=stores,
                jres2=jres2.as_dict(), jfull=jfull.as_dict())


@pytest.fixture(scope="module")
def on_router(served):
    """F13: the spawn of :func:`torch_mesh_ranks.mesh_router`."""
    return _spawn(ranks.mesh_router, served["rb"][0], served["rb"][1], served["baskets"], served["extra"],
                  served["store"], CFG, TOP_K, MAX_BATCH, CLIENTS)


@pytest.fixture(scope="module")
def on_single(served, tmp_path_factory):
    """F12: the spawn of :func:`torch_mesh_ranks.mesh_refresh_single`."""
    return _spawn(ranks.mesh_refresh_single, served["rb"][0], served["baskets"], served["stores"], CFG, TOP_K,
                  MAX_BATCH, CLIENTS, str(tmp_path_factory.mktemp("hold")))


def _loads(leader, *keys):
    """The responses of the leader's loads ``keys``, each by basket, and
    their failures."""
    got, failed = [], []
    for key in keys:
        responses, errors = leader[key]
        got.append(responses)
        failed += errors
    return got, failed


def _bit_for_bit(responses, refs):
    """Each response (basket i) bit for bit its generation's reference at
    its bucket."""
    for i, r in enumerate(responses):
        items, scores = refs[(r.generation, r.bucket)]
        np.testing.assert_array_equal(r.items, items[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), scores[i].view(np.uint32))


# ------------------------------------------------------------------ F13 --
def test_f13_router_on_a_mesh_serves_bit_for_bit_the_mesh_recommend(on_router, served):
    """Zero drops through the kill and the swap at half load and through the
    refresh; the kill fired once, replica 0's worker was restarted and its
    requests failed over; every response is bit for bit the mesh
    ``recommend`` of its generation at its bucket, the same on every rank;
    a follower's router admits nothing and swaps nothing."""
    leader = on_router[0]
    (load, during, after), failed = _loads(leader, "load", "during", "after")
    n = len(served["baskets"])
    assert failed == [] and all(r is not None for r in load + during + after)
    assert len(load) == len(during) == len(after) == n
    assert leader["swapped"] == 1 and sorted({r.generation for r in load}) == [0, 1]
    assert leader["kills_fired"] == 1
    before = leader["before_refresh"]
    assert before["failovers"] >= 1 and before["supervisor"]["restarts"][0] >= 1
    assert [r["state"] for r in before["replicas"]] == ["healthy"] * 2
    for responses in (load, during, after):
        _bit_for_bit(responses, leader["refs"])
    for other in on_router[1:]:
        for key, (items, scores) in leader["refs"].items():
            np.testing.assert_array_equal(other["refs"][key][0], items)
            np.testing.assert_array_equal(other["refs"][key][1].view(np.uint32), scores.view(np.uint32))
        for what in ("submit", "stats", "hot_swap"):
            assert "holds the mesh router's follower replicas" in other[f"follower_{what}"]


def test_f13_responses_within_tolerance_of_jax_recommend(on_router, served):
    leader = on_router[0]
    (load, during, after), _ = _loads(leader, "load", "during", "after")
    want = {g: jrecommend(served["jrb"][g], served["baskets"], top_k=TOP_K, batch_size=30, impl="jnp")
            for g in (0, 1, 2)}
    for responses in (load, during, after):
        for i, r in enumerate(responses):
            _held(r.items, r.scores, np.asarray(want[r.generation].items)[i],
                  np.asarray(want[r.generation].scores)[i])


def test_f13_refresh_of_a_mesh_router_mines_once_and_commits_every_replica(on_router, served):
    """One mine a rank (in its ``refresh_now`` thread on the leader, in the
    controller's loop on a follower), dict-identical to JAX's
    ``mine_delta``; each replica on each rank placed generation 2 once,
    from the rulebook its own rank mined; both replicas serve generation 2
    on every rank when ``refresh_now`` returns there, and are healthy."""
    for per_rank in on_router:
        assert per_rank["refreshed"] == 2 and per_rank["generations"] == [2, 2]
        assert per_rank["mines"] == (["test-refresh"] if per_rank["rank"] == 0 else ["refresh-follower"])
        assert per_rank["result"] == served["jres2"]
        (record,) = per_rank["history"]
        assert record["generation"] == 2 and record["mode"] == "delta" and record["watermark"] == 440
        assert per_rank["placed"] == [[(2, True)], [(2, True)]]
    leader = on_router[0]
    stats = leader["stats"]
    assert [(r["state"], r["generation"]) for r in stats["replicas"]] == [("healthy", 2)] * 2
    assert stats["target_generation"] == 2
    (_, during, after), _ = _loads(leader, "load", "during", "after")
    assert {r.generation for r in during} <= {1, 2} and {r.generation for r in after} == {2}


def test_f13_every_group_serves_one_thread(on_router):
    """Each replica's collectives go to its own mesh's groups and the mine's
    to the controller's mine mesh, no two of the three share a group, none
    went to the default group, no two threads were ever in one group at
    once, and on a follower each replica's groups served the thread that
    built the replica (its construction's exchange) and then its follow
    thread alone, and the mine's groups the controller's loop alone."""
    for per_rank in on_router:
        groups = per_rank["groups"]
        assert groups["wrong"] == [] and groups["overlaps"] == [] and groups["shared"] == []
        assert groups["mine"] > 0 and all(r["calls"] > 0 for r in groups["replicas"])
        assert groups["mine_threads"] == 1
        if per_rank["rank"]:
            assert [(r["threads"], r["switches"]) for r in groups["replicas"]] == [(2, 1), (2, 1)]
        assert per_rank["threads_after_close"] == []


# ------------------------------------------------------------------ F12 --
def test_f12_a_single_device_router_is_refreshed_by_a_mesh_mine(on_single, served):
    """Rank 0's ``Router(rb, 2)`` moves from generation 0 to 1 while it
    serves, both replicas committed; every rank mined the delta,
    dict-identical to JAX's ``mine_delta``; zero drops, each response bit
    for bit the single-device ``recommend`` of its generation."""
    leader = on_single[0]["router"]
    assert leader["refreshed"] == 1 and leader["generations"] == [1, 1] and leader["target"] == 1
    (before, during, after), failed = _loads(leader, "before", "during", "after")
    assert failed == [] and all(r is not None for r in before + during + after)
    assert {r.generation for r in before} == {0} and {r.generation for r in during} <= {0, 1}
    assert {r.generation for r in after} == {1}
    for responses in (before, during, after):
        _bit_for_bit(responses, on_single[0]["refs"])
    for per_rank in on_single:
        assert per_rank["router"]["result"] == served["jres2"]
        (record,) = per_rank["router"]["history"]
        assert record["generation"] == 1 and record["mode"] == "delta" and record["watermark"] == 440


def test_f12_a_single_device_gateway_is_refreshed_by_a_mesh_mine(on_single, served):
    leader = on_single[0]["gateway"]
    assert leader["refreshed"] == dict(value=1)
    responses, failed = leader["after"]
    assert failed == [] and {r.generation for r in responses} == {1}
    _bit_for_bit(responses, on_single[0]["refs"])
    for per_rank in on_single:
        assert per_rank["gateway"]["result"] == served["jres2"]
        assert per_rank["gateway"]["history"][-1]["generation"] == 1


def test_f12_a_followers_refresh_now_returns_the_leaders_generation(on_single):
    for per_rank in on_single[1:]:
        assert per_rank["router"]["refreshed"] == 1
        assert per_rank["gateway"]["refreshed"] == dict(value=1)
        assert per_rank["full"]["refreshed"] == dict(value=1)
        assert [h["generation"] for h in per_rank["router"]["history"]] == [1]


def test_f12_a_failed_cycle_keeps_the_generation_and_the_next_commits(on_single, served):
    """The mine raises on rank 3 alone: every rank's ``refresh_now`` raises
    with its error and counts one failure, rank 0's gateway serves
    generation 0 on with zero drops, and the next cycle commits
    generation 1 on every rank."""
    for per_rank in on_single:
        gw = per_rank["gateway"]
        assert "the mine fails on rank 3 on purpose" in gw["failed"]["error"] and gw["failures"] == 1
        assert gw["refreshed"] == dict(value=1) and gw["calls"] == 2
    generation, (responses, failed) = on_single[0]["gateway"]["kept"]
    assert generation == 0 and failed == [] and {r.generation for r in responses} == {0}
    _bit_for_bit(responses, on_single[0]["refs"])
    assert "keeps serving: the refresh's mine failed on 1 rank(s)" in on_single[0]["gateway"]["failed"]["error"]


def test_f12_mode_full_mines_the_whole_store_as_jax(on_single, served):
    assert on_single[0]["full"]["refreshed"] == dict(value=1) and on_single[0]["full"]["generation"] == 1
    for per_rank in on_single:
        (record,) = per_rank["full"]["history"]
        assert record["mode"] == "full" and record["generation"] == 1
        assert per_rank["full"]["result"] == served["jfull"] == served["jres2"]


def test_f12_close_during_a_cycle_commits_nothing_and_ends_every_loop(on_single):
    """Rank 0 closes the controller while the cycle's mine is held on every
    rank: its close waits for the mine, the cycle commits nothing (every
    rank's ``refresh_now`` raises, generation 0 serves on), every
    follower's loop ends, a later ``refresh_now`` raises on every rank, and
    no rank is left with a thread of the tier."""
    leader = on_single[0]["close"]
    assert leader["close_waited"] and leader["closed"] and leader["generation"] == 0
    for per_rank in on_single:
        closed = per_rank["close"]
        assert "closed during the cycle" in closed["refreshed"]["error"] and closed["history"] == []
        assert per_rank["threads_after_close"] == []
    assert "the refresh controller is closed" in leader["again"]["error"]
    for per_rank in on_single[1:]:
        assert "follow loop ended before the refresh" in per_rank["close"]["again"]["error"]


@pytest.mark.parametrize("case", ["f12", "f13"])
def test_responses_within_tolerance_of_jax_recommend(on_single, on_router, served, case):
    if case == "f13":
        leader = on_router[0]
        responses = [r for key in ("load", "during", "after") for r in leader[key][0]]
    else:
        leader = on_single[0]
        responses = [r for key in ("before", "during", "after") for r in leader["router"][key][0]]
    per_load = len(served["baskets"])
    want = {g: jrecommend(served["jrb"][g], served["baskets"], top_k=TOP_K, batch_size=30, impl="jnp")
            for g in (0, 1, 2)}
    gens = {0: 0, 1: 2} if case == "f12" else {0: 0, 1: 1, 2: 2}   # F12's generation 1 is the refresh
    for i, r in enumerate(responses):
        w = want[gens[r.generation]]
        _held(r.items, r.scores, np.asarray(w.items)[i % per_load], np.asarray(w.scores)[i % per_load])


# ---------------------------------------------------------- the reference --
# JAX's Router, once of single-device replicas (F12) and once on the mesh
# (F13), refreshed by RefreshController(router, mesh=mesh) on 4 host devices;
# the script wraps the controller's compile_rulebook to keep the mined result
_JAX_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import numpy as np
    import jax
    from repro.core import apriori as japr
    from repro.core import incremental as jinc
    from repro.data import store as jds
    from repro.data.synthetic import QuestConfig, gen_transactions
    from repro.serving import refresh as jrefresh
    from repro.serving.router import Router
    from repro.serving.rulebook import compile_rulebook

    root = sys.argv[1]
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    rb0 = compile_rulebook(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    cfg = japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp", representation="packed",
                             data_axes=("data",), model_axis="model")
    mined = []
    jrefresh.compile_rulebook = lambda res, **kw: (mined.append(res), compile_rulebook(res, **kw))[1]
    out = {}
    for name, kw in (("f12", {}), ("f13", dict(mesh=mesh, data_axes=("data",), rule_axis="model"))):
        path = os.path.join(root, name)
        jds.ingest_dense(db, path, shard_rows=100)
        jinc.build_count_cache(jds.open_store(path), cfg, mesh, chunk_rows=64)
        jds.append_chunks([extra], path)
        router = Router(rb0, 2, impl="jnp", top_k=5, max_batch=16, **kw)
        try:
            ctl = jrefresh.RefreshController(path, router, cfg, mesh=mesh, chunk_rows=64, min_confidence=0.4)
            before = router.generation
            refreshed = ctl.refresh_now()
            got = [router.query(np.flatnonzero(b).tolist()) for b in db[:90]]
            out[name] = dict(before=before, refreshed=refreshed, mode=ctl.history[-1]["mode"],
                             generations=[rep.gateway.generation for rep in router.replicas],
                             answered=sorted({r.generation for r in got}),
                             result=sorted([list(k), int(v)] for k, v in mined[-1].as_dict().items()))
            np.savez(os.path.join(root, name + ".npz"), items=np.stack([r.items for r in got]),
                     scores=np.stack([r.scores for r in got]), buckets=np.array([r.bucket for r in got]))
        finally:
            router.close()
    print("JAX_REF", json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def on_jax(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-router")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(root)], capture_output=True, text=True,
                          timeout=600, env=subprocess_env(), cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("JAX_REF ")]
    out = json.loads(line[len("JAX_REF "):])
    for name in out:
        out[name]["responses"] = dict(np.load(os.path.join(root, name + ".npz")))
    return out


@pytest.mark.parametrize("case", ["f12", "f13"])
def test_the_jax_router_is_refreshed_by_a_mesh_mine(on_jax, served, case):
    """The reference: JAX's ``Router(rb, 2)`` (F12) and ``Router(rb, 2,
    mesh=mesh)`` (F13) on a 2 x 2 mesh of 4 host devices, refreshed by
    ``RefreshController(router, mesh=mesh)``: generation 0 to 1 on both
    replicas, the delta mine equal to JAX's single-device ``mine_delta``
    of the same rows, then answers within tolerance of ``recommend`` of the
    refreshed rulebook (F12: bit for bit at each response's bucket)."""
    ref = on_jax[case]
    assert (ref["before"], ref["refreshed"], ref["generations"], ref["answered"]) == (0, 1, [1, 1], [1])
    assert ref["mode"] == "delta" and {tuple(k): v for k, v in ref["result"]} == served["jres2"]
    got, baskets = ref["responses"], served["baskets"]
    want = jrecommend(served["jrb"][2], baskets, top_k=TOP_K, batch_size=30, impl="jnp")
    _held(got["items"], got["scores"], np.asarray(want.items), np.asarray(want.scores))
    if case == "f12":
        for i, bucket in enumerate(got["buckets"]):
            w = jrecommend(served["jrb"][2], baskets, top_k=TOP_K, batch_size=int(bucket), impl="jnp")
            np.testing.assert_array_equal(got["items"][i], np.asarray(w.items)[i])
            np.testing.assert_array_equal(got["scores"][i].view(np.uint32), np.asarray(w.scores)[i].view(np.uint32))
