"""PyTorch port: a mesh refresh that mines on a mesh of its own shape (F14)
— ``RefreshController(target, mesh=mine)`` where the target serves on
another mesh of the same ranks — over spawned CPU ranks (gloo), at the size
of ``test_torch_mesh_router.py``: the 400 x 64 DB, its count cache, 40 rows
appended.

Every rank serves on the spawn's 2 x 2 ``("data", "model")`` mesh and mines
on a (4, 1) ``("data", "model")`` mesh built in the rank, as the JAX
package's controller mines on its ``mesh`` and its target's ``hot_swap``
places the rulebook on the target's own mesh.  Three targets, each on its
own copy of the store (:func:`torch_mesh_ranks.mesh_refresh_reshaped`):

* a mesh ``Gateway``: a cycle whose mine raises on rank 3 fails on every
  rank while generation 0 serves on; the next commits generation 1 while
  rank 0 serves 90 baskets from 4 threads before, during and after it;
  then a cycle whose mine is held on every rank while rank 0 closes the
  gateway;
* ``Router(rb, 2, mesh=)``: a cycle under load, each replica placing its
  block of its own rank's rulebook; then a cycle whose mine is held while
  rank 0 closes the controller;
* a mesh ``Gateway`` with ``mode="full"``, after a controller whose
  followers passed None for it was refused on every rank.

Every response is bit for bit its generation's mesh ``recommend`` on the
2 x 2 mesh at its bucket and within rtol 1e-5, atol 1e-6 of JAX's
``recommend``; every rank's mine is dict-identical to JAX's ``mine_delta``
(``mine_streamed`` in full mode), and the mine's collectives touch no group
of the serving mesh nor of the (4, 1) mesh the caller passed.  The JAX
reference serves both targets on 4 host devices in a subprocess.
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
LOADS = {"gateway": ("kept", "before", "during", "after"), "router": ("before", "during", "after"),
         "full": ("after",)}


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
    """The DB and generation 0's rulebook of ``test_torch_mesh_router.py``,
    three copies of a store of the DB with its count cache and the 40 rows
    appended, and the references: JAX's ``mine_delta`` and
    ``mine_streamed`` of the grown store, and the rulebook compiled from
    the first."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    jrb0 = jcompile(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    root = tmp_path_factory.mktemp("mesh-refresh-meshes")
    store, jax_store = str(root / "store"), str(root / "jax-store")
    jds.ingest_dense(db, store, shard_rows=100)
    shutil.copytree(store, jax_store)
    inc.build_count_cache(open_store(store), CFG, "cpu", chunk_rows=64)
    jinc.build_count_cache(jds.open_store(jax_store), JCFG, chunk_rows=64)
    for path in (store, jax_store):
        jds.append_chunks([extra], path)
    stores = {}
    for name in ("gateway", "router", "full"):
        stores[name] = str(root / name)
        shutil.copytree(store, stores[name])
    jfull = jst.mine_streamed(jds.open_store(jax_store), JCFG, chunk_rows=64)
    jres1, jrep1 = jinc.mine_delta(jds.open_store(jax_store), JCFG, chunk_rows=64)
    assert jrep1.mode == "delta"
    jrb1 = jcompile(jres1, min_confidence=0.4, num_items=64)
    return dict(db=db, extra=extra, baskets=db[:90], jrb={0: jrb0, 1: jrb1}, rb0=_port(jrb0), stores=stores,
                jres1=jres1.as_dict(), jfull=jfull.as_dict())


@pytest.fixture(scope="module")
def reshaped(served, tmp_path_factory):
    """The spawn of :func:`torch_mesh_ranks.mesh_refresh_reshaped` on the
    2 x 2 mesh."""
    return spawn(ranks.mesh_refresh_reshaped, (2, 2), ("data", "model"), device="cpu", backend="gloo",
                 timeout_s=DEADLINE_S, args=(served["rb0"], served["baskets"], served["extra"], served["stores"],
                                             CFG, TOP_K, MAX_BATCH, CLIENTS, str(tmp_path_factory.mktemp("hold"))))


def _responses(leader, stage, keys=None):
    """The responses of rank 0's loads of ``stage`` (by basket), and their
    failures."""
    got, failed = [], []
    for key in keys or LOADS[stage]:
        responses, errors = leader[stage][key]
        got.append(responses)
        failed += errors
    return got, failed


def _bit_for_bit(stage, responses, refs):
    """Each response (basket i) bit for bit its generation's mesh
    ``recommend`` at its bucket."""
    for i, r in enumerate(responses):
        items, scores = refs[(stage, r.generation, r.bucket)]
        np.testing.assert_array_equal(r.items, items[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), scores[i].view(np.uint32))


@pytest.mark.parametrize("stage", ["gateway", "router"])
def test_f14_a_mesh_target_is_refreshed_under_load_by_a_mine_of_another_shape(reshaped, served, stage):
    """Rank 0's target moves from generation 0 to 1 while it serves: zero
    drops, generation 0 before the refresh, 0 or 1 during it, 1 after;
    every response bit for bit its generation's mesh ``recommend`` on the
    2 x 2 mesh; every rank mined the delta on the (4, 1) mesh,
    dict-identical to JAX's ``mine_delta``."""
    leader = reshaped[0]
    loads, failed = _responses(leader, stage, ("before", "during", "after"))
    before, during, after = loads
    assert failed == [] and all(r is not None for r in before + during + after)
    assert {r.generation for r in before} == {0} and {r.generation for r in during} <= {0, 1}
    assert {r.generation for r in after} == {1}
    for responses in loads:
        _bit_for_bit(stage, responses, leader["refs"])
    for per_rank in reshaped:
        st = per_rank[stage]
        assert st["result"] == served["jres1"]
        record = st["history"][0]
        assert (record["generation"], record["mode"], record["watermark"]) == (1, "delta", 440)


def test_f14_a_mesh_router_places_each_replica_from_its_own_ranks_rulebook(reshaped):
    """Both replicas serve generation 1 on every rank when ``refresh_now``
    returns there, each placed once from the rulebook its own rank mined."""
    for per_rank in reshaped:
        st = per_rank["router"]
        assert st["refreshed"]["value"] == 1 and st["refreshed"]["serving"] == [1, 1]
        assert st["placed"] == [[1], [1]]


def test_f14_mode_full_mines_the_whole_store_as_jax(reshaped, served):
    responses, failed = reshaped[0]["full"]["after"]
    assert failed == [] and {r.generation for r in responses} == {1}
    _bit_for_bit("full", responses, reshaped[0]["refs"])
    for per_rank in reshaped:
        st = per_rank["full"]
        assert st["refreshed"] == dict(value=1, serving=1)
        (record,) = st["history"]
        assert record["mode"] == "full" and record["generation"] == 1
        assert st["result"] == served["jfull"] == served["jres1"]


def test_f14_a_failed_cycle_keeps_the_generation_and_the_next_commits(reshaped):
    """The mine raises on rank 3 alone: every rank's ``refresh_now`` raises
    with its error and counts one failure, generation 0 serves on (rank 0
    answers every basket with it, bit for bit), and the next cycle commits
    generation 1 on every rank."""
    for per_rank in reshaped:
        st = per_rank["gateway"]
        assert "the mine fails on rank 3 on purpose" in st["failed"]["error"] and st["failed"]["serving"] == 0
        assert st["failures"] == 1 and st["refreshed"]["value"] == 1
    assert "keeps serving: the refresh's mine failed on 1 rank(s)" in reshaped[0]["gateway"]["failed"]["error"]
    (kept,), failed = _responses(reshaped[0], "gateway", ("kept",))
    assert failed == [] and {r.generation for r in kept} == {0}
    _bit_for_bit("gateway", kept, reshaped[0]["refs"])


@pytest.mark.parametrize("stage", ["gateway", "router"])
def test_f14_a_followers_refresh_now_returns_the_generation_that_serves_there(reshaped, stage):
    want = 1 if stage == "gateway" else [1, 1]
    for per_rank in reshaped[1:]:
        assert per_rank[stage]["refreshed"] == dict(value=1, serving=want)
        assert [h["generation"] for h in per_rank[stage]["history"]] == [1]


@pytest.mark.parametrize("stage", ["gateway", "router"])
def test_f14_close_during_a_held_mine_commits_nothing_and_leaves_no_thread(reshaped, stage):
    """Rank 0 closes the gateway (or the controller) while the third (or
    second) cycle's mine is held on every rank: the cycle commits nothing,
    generation 1 serves on, every rank's ``refresh_now`` raises, every
    rank mined it once, and no rank is left with a thread of the tier.
    The controller's close waits for the mine; the gateway's does not."""
    leader = reshaped[0][stage]["closing"]
    assert leader["closed"] and leader["close_waited"] == (stage == "router")
    want = dict(gateway="the gateway is closed", router="closed during the cycle")[stage]
    assert want in leader["refreshed"]["error"]
    serving = 1 if stage == "gateway" else [1, 1]
    for per_rank in reshaped:
        st = per_rank[stage]
        assert st["closing"]["refreshed"].get("value") is None and st["closing"]["refreshed"]["serving"] == serving
        assert [h["generation"] for h in st["history"]] == [1]
        assert st["mines"] == (3 if stage == "gateway" else 2)
        assert per_rank["threads_after_close"] == []
    # a follower: the gateway's follow loop ended at its STOP; the controller's outcome of the cycle
    want = dict(gateway="follow loop ended before the refresh", router="closed during the cycle")[stage]
    for per_rank in reshaped[1:]:
        assert want in per_rank[stage]["closing"]["refreshed"]["error"]
        if stage == "router":
            assert "follow loop ended before the refresh" in per_rank["router"]["again"]["error"]
    if stage == "router":
        assert "the refresh controller is closed" in reshaped[0]["router"]["again"]["error"]


@pytest.mark.parametrize("stage", ["gateway", "router"])
def test_f14_the_mine_uses_no_group_of_the_serving_or_the_callers_mesh(reshaped, stage):
    """The mine's collectives go to the controller's mine mesh (a twin of
    the (4, 1) mesh, rebuilt after the failed cycle) alone, serving's to
    the target's meshes alone; no group of the (4, 1) mesh the caller
    passed carries any collective, no two of the three share a group, and
    no two threads were ever in one group at once."""
    for per_rank in reshaped:
        groups = per_rank[stage]["groups"]
        assert groups["mine"] > 0 and groups["serving"] > 0 and groups["caller"] == 0
        assert groups["wrong"] == [] and groups["shared"] == [] and groups["overlaps"] == []


def test_f14_a_follower_passing_none_for_a_mesh_target_is_refused_on_every_rank(reshaped):
    for per_rank in reshaped:
        text = per_rank["full"]["refused"]
        assert "refreshes a mesh Gateway or mesh Router built on any mesh of the same ranks" in text
        assert "rank 0 a mesh Gateway of 4 ranks, rank 1 None, rank 2 None, rank 3 None" in text


def test_f14_responses_within_tolerance_of_jax_recommend(reshaped, served):
    leader = reshaped[0]
    want = {g: jrecommend(served["jrb"][g], served["baskets"], top_k=TOP_K, batch_size=30, impl="jnp")
            for g in (0, 1)}
    for stage in LOADS:
        loads, _ = _responses(leader, stage)
        for responses in loads:
            for i, r in enumerate(responses):
                w = want[r.generation]
                _held(r.items, r.scores, np.asarray(w.items)[i], np.asarray(w.scores)[i])


# ---------------------------------------------------------- the reference --
# JAX's mesh Gateway and mesh Router serving on a 2 x 2 mesh of 4 host
# devices, each refreshed by RefreshController(target, mesh=) on a (4, 1)
# mesh of the same devices; the script wraps the controller's
# compile_rulebook to keep the mined result
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
    from repro.serving.gateway import Gateway
    from repro.serving.router import Router
    from repro.serving.rulebook import compile_rulebook

    root = sys.argv[1]
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    rb0 = compile_rulebook(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    serving = jax.make_mesh((2, 2), ("data", "model"))
    mining = jax.make_mesh((4, 1), ("data", "model"))
    cfg = japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp", representation="packed",
                             data_axes=("data",), model_axis="model")
    mined = []
    jrefresh.compile_rulebook = lambda res, **kw: (mined.append(res), compile_rulebook(res, **kw))[1]
    kw = dict(mesh=serving, impl="jnp", top_k=5, max_batch=16, data_axes=("data",), rule_axis="model")
    out = {}
    for name in ("gateway", "router"):
        path = os.path.join(root, name)
        jds.ingest_dense(db, path, shard_rows=100)
        jinc.build_count_cache(jds.open_store(path), cfg, mining, chunk_rows=64)
        jds.append_chunks([extra], path)
        target = Gateway(rb0, **kw) if name == "gateway" else Router(rb0, 2, **kw)
        try:
            ctl = jrefresh.RefreshController(path, target, cfg, mesh=mining, chunk_rows=64, min_confidence=0.4)
            before = target.generation
            refreshed = ctl.refresh_now()
            got = [target.query(np.flatnonzero(b).tolist()) for b in db[:90]]
            generations = ([target.generation] if name == "gateway"
                           else [rep.gateway.generation for rep in target.replicas])
            out[name] = dict(before=before, refreshed=refreshed, mode=ctl.history[-1]["mode"],
                             generations=generations, answered=sorted({r.generation for r in got}),
                             result=sorted([list(k), int(v)] for k, v in mined[-1].as_dict().items()))
            np.savez(os.path.join(root, name + ".npz"), items=np.stack([r.items for r in got]),
                     scores=np.stack([r.scores for r in got]))
        finally:
            target.close()
    print("JAX_REF", json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def on_jax(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-reshaped")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(root)], capture_output=True, text=True,
                          timeout=600, env=subprocess_env(), cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("JAX_REF ")]
    out = json.loads(line[len("JAX_REF "):])
    for name in out:
        out[name]["responses"] = dict(np.load(os.path.join(root, name + ".npz")))
    return out


@pytest.mark.parametrize("stage", ["gateway", "router"])
def test_the_jax_target_is_refreshed_by_a_mine_of_another_shape(on_jax, reshaped, served, stage):
    """The reference: JAX's mesh ``Gateway`` and ``Router(rb, 2, mesh=)`` on
    a 2 x 2 mesh of 4 host devices, refreshed by ``RefreshController(target,
    mesh=)`` on a (4, 1) mesh of the same devices: generation 0 to 1, the
    delta mine equal to JAX's single-device ``mine_delta`` of the same rows
    and to every port rank's, then answers within tolerance of
    ``recommend`` of the refreshed rulebook and of the port's responses."""
    ref = on_jax[stage]
    want_gens = [1] if stage == "gateway" else [1, 1]
    assert (ref["before"], ref["refreshed"], ref["generations"], ref["answered"]) == (0, 1, want_gens, [1])
    assert ref["mode"] == "delta" and {tuple(k): v for k, v in ref["result"]} == served["jres1"]
    for per_rank in reshaped:
        assert per_rank[stage]["result"] == served["jres1"]
    got, baskets = ref["responses"], served["baskets"]
    want = jrecommend(served["jrb"][1], baskets, top_k=TOP_K, batch_size=30, impl="jnp")
    _held(got["items"], got["scores"], np.asarray(want.items), np.asarray(want.scores))
    (after,), _ = _responses(reshaped[0], stage, ("after",))
    _held(np.stack([r.items for r in after]), np.stack([r.scores for r in after]), got["items"], got["scores"])
