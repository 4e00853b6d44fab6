"""PyTorch port: the serving tier on a mesh (module 7b) — ``Gateway(mesh=)``
and ``RefreshController(mesh=)`` over spawned CPU ranks (gloo).

Rank 0 leads: it admits the requests and broadcasts each padded bucket to
the other ranks, which follow.  On a (2, 3) data x model mesh (two basket
shards, three uneven rule shards of the JAX test's 2,071-rule rulebook)
every response is bit for bit the port's mesh ``recommend`` of its
generation at its bucket (the rule blocks are summed in block order, so a
basket's scores do not depend on its batch), within rtol 1e-5, atol 1e-6
of the port's single-device ``recommend`` and of JAX's
``recommend(impl="jnp")``, with items equal except within tolerance of a
tie.  (Not bit for bit the single device's: one device carries one fp32
sum through all the rules, a mesh adds three block sums.)  The load runs
through a mid-load hot swap, a refresh that fails on every rank (the
generation stays) and a delta refresh on every rank, with zero drops, and
every rank answers every batch with the same generation.  The
places where a leader and its followers go wrong each have a test: idle
followers past the groups' timeout, a follower that dies, the bucket
ladder, and a mesh of one rank.

F8: a refresh on the mesh mines beside serving, on a second mesh of its
own, as the JAX package's refresh mines beside its gateway.  The same
spawn then runs three refresh cycles whose mines are held on every rank by
a file protocol (``torch_mesh_ranks.HeldMines``): requests submitted with
a deadline while a mine is held are answered by the serving generation; an
operator's swap during a held mine takes its own generation and the
refresh the next; a mine that fails on one follower fails the cycle on
every rank while serving goes on; ``close()`` during a held mine returns
and leaves no thread.  Every collective of the spawn is logged: the mine's
go only to the mine mesh's groups, serving's only to the gateway's, and no
two threads are ever in one group at once.
"""

import os
import shutil
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core import incremental as jinc  # noqa: E402
from repro.data import store as jds  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro.serving.recommend import recommend as jrecommend  # noqa: E402
from repro.serving.rulebook import compile_rulebook as jcompile  # noqa: E402
from repro_torch.core import incremental as inc  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.data.store import open_store  # noqa: E402
from repro_torch.launch.mesh import RankFailed, spawn  # noqa: E402
from repro_torch.serving.gateway import pow2_bucket  # noqa: E402
from repro_torch.serving.recommend import recommend  # noqa: E402
from repro_torch.serving.rulebook import rulebook_from_arrays  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
TOP_K, MAX_BATCH, CLIENTS = 5, 16, 4
DEADLINE_S = 90.0
JCFG = japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp", representation="packed")
CFG = AprioriConfig(min_support=0.04, max_k=4, representation="packed", data_axes=("data",),
                    model_axis="model")


def _spawn(fn, shape, *args, timeout_s=DEADLINE_S):
    return spawn(fn, shape, ("data", "model"), device="cpu", backend="gloo", timeout_s=timeout_s, args=args)


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
    """The JAX test's DB and rulebook (gen 0), a second rulebook (gen 1),
    a store of the DB with its count cache and 40 appended rows (gen 2 is
    its delta mine), and the references: JAX's ``mine_delta`` of a copy
    of the grown store, and the port's single-device mine of the grown DB."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    res1 = japr.mine(db, japr.AprioriConfig(min_support=0.06, max_k=4, count_impl="jnp"))
    # 2,071 rules in 2,072 rows: three rule shards split it unevenly
    jrb0 = jcompile(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    jrb1 = jcompile(res1, min_confidence=0.5, num_items=64, pad_multiple=8)
    root = tmp_path_factory.mktemp("mesh-gateway")
    store, jax_store = str(root / "store"), str(root / "jax-store")
    jds.ingest_dense(db, store, shard_rows=100)
    shutil.copytree(store, jax_store)
    inc.build_count_cache(open_store(store), CFG, "cpu", chunk_rows=64)
    jinc.build_count_cache(jds.open_store(jax_store), JCFG, chunk_rows=64)
    for path in (store, jax_store):
        jds.append_chunks([extra], path)
    idle_store = str(root / "idle-store")   # the grown store with its cache, before any refresh
    shutil.copytree(store, idle_store)
    jres2, jrep2 = jinc.mine_delta(jds.open_store(jax_store), JCFG, chunk_rows=64)
    grown = np.concatenate([db, extra])
    single2 = mine(grown, AprioriConfig(min_support=0.04, max_k=4, representation="packed"), device="cpu")
    baskets = db[:90]
    return dict(db=db, baskets=baskets, jrb={0: jrb0, 1: jrb1}, rb={0: _port(jrb0), 1: _port(jrb1)},
                store=store, jax_store=jax_store, idle_store=idle_store, jres2=jres2.as_dict(), jrep2=jrep2,
                single2=single2.as_dict())


@pytest.fixture(scope="module")
def on_2x3(served, tmp_path_factory):
    rb, baskets = served["rb"], served["baskets"]
    return _spawn(ranks.mesh_gateway, (2, 3), rb[0], rb[1], baskets, served["store"], CFG, TOP_K, MAX_BATCH,
                  CLIENTS, str(tmp_path_factory.mktemp("hold")))


def _responses(leader):
    load, failed = leader["load"]
    after, failed_after = leader["after"]
    return load, after, failed + failed_after


def test_zero_drops_through_the_swap_and_the_refresh(on_2x3, served):
    leader = on_2x3[0]
    load, after, failed = _responses(leader)
    n = len(served["baskets"])
    assert not failed and all(r is not None for r in load + after) and len(load) == len(after) == n
    assert sorted({r.generation for r in load}) == [0, 1]
    assert {r.generation for r in after} == {2} and leader["alone"].generation == 2
    assert [o["refreshed"] for o in on_2x3] == [2] * 6
    for follower in on_2x3[1:]:
        assert "follows the mesh gateway's leader" in follower["follower_submit"]


def test_a_failed_refresh_leaves_the_generation_serving_on_every_rank(on_2x3):
    """A cycle under a config every rank refuses fails on every rank, the
    leader's ``refresh_now`` and each follower's raise, and generation 1
    keeps serving until the next cycle."""
    for per_rank in on_2x3:
        assert "bitmap" in per_rank["failed_refresh"] and per_rank["kept"] == 1
        assert per_rank["failures"] == 1


def test_every_response_is_bit_for_bit_the_mesh_recommend_of_its_generation(on_2x3, served):
    leader = on_2x3[0]
    load, after, _ = _responses(leader)
    for i, r in list(enumerate(load)) + list(enumerate(after)) + [(0, leader["alone"])]:
        items, scores = leader["refs"][(r.generation, r.bucket)]
        np.testing.assert_array_equal(r.items, items[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), scores[i].view(np.uint32))
    for other in on_2x3[1:]:   # every rank's mesh recommend is the same
        for key, (items, scores) in leader["refs"].items():
            np.testing.assert_array_equal(other["refs"][key][0], items)
            np.testing.assert_array_equal(other["refs"][key][1].view(np.uint32), scores.view(np.uint32))


@pytest.mark.parametrize("ref", ["jax", "single_device"])
def test_responses_within_tolerance_of_jax_and_the_single_device(on_2x3, served, ref):
    leader = on_2x3[0]
    baskets = served["baskets"]
    jrb = dict(served["jrb"])
    jrb[2] = jcompile(japr.AprioriResult(levels=_levels(served["jres2"]), num_transactions=440,
                                         min_count=int(np.ceil(0.04 * 440))),
                      min_confidence=0.4, num_items=64)
    want = {}
    for g in (0, 1, 2):
        if ref == "jax":
            want[g] = jrecommend(jrb[g], baskets, top_k=TOP_K, batch_size=30, impl="jnp")
        else:
            rb = served["rb"][g] if g < 2 else leader["rb2"]
            want[g] = recommend(rb, baskets, top_k=TOP_K, batch_size=30, device="cpu")
    load, after, _ = _responses(leader)
    for i, r in list(enumerate(load)) + list(enumerate(after)):
        _held(r.items, r.scores, np.asarray(want[r.generation].items)[i], np.asarray(want[r.generation].scores)[i])


def _levels(as_dict):
    """An ``as_dict()`` back to levels, rows in lexicographic order."""
    by_k = {}
    for itemset, sup in sorted(as_dict.items()):
        by_k.setdefault(len(itemset), []).append((itemset, sup))
    return {k: (np.array([s for s, _ in v], np.int32), np.array([c for _, c in v], np.int64))
            for k, v in by_k.items()}


def test_every_rank_answers_every_batch_with_one_generation(on_2x3):
    """The generation a batch's command names is the one every rank
    answers it with: the ranks' logs of (generation, bucket) are equal."""
    log = on_2x3[0]["answered"]
    assert log and {g for g, _ in log} == {0, 1, 2}
    for other in on_2x3[1:]:
        assert other["answered"] == log


def test_refresh_on_the_mesh_equals_jax_mine_delta_and_the_single_device_mine(on_2x3, served):
    assert served["jrep2"].mode == "delta"
    for per_rank in on_2x3:
        assert per_rank["result"] == served["jres2"] == served["single2"]
        (record,) = per_rank["history"]
        assert record["generation"] == 2 and record["mode"] == "delta" and record["watermark"] == 440
        assert record["rules"] == on_2x3[0]["rb2"].num_rules


def test_buckets_split_evenly_and_the_warmed_ladder_is_the_served_one(on_2x3):
    leader = on_2x3[0]
    ladder = [pow2_bucket(n, MAX_BATCH, 2) for n in (1, 2, 4, 8, 16)]
    assert ladder == [2, 2, 4, 8, 16]
    for per_rank in on_2x3:
        assert per_rank["ladder"] == sorted(set(ladder))
    load, after, _ = _responses(leader)
    assert {r.bucket for r in load + after} <= set(leader["ladder"])
    assert {b for _, b in leader["answered"]} <= set(leader["ladder"])
    assert leader["alone"].bucket == 2   # a bucket of 1 on 2 data shards pads to 2


def test_idle_followers_outlive_the_group_timeout(served):
    """Groups that time out after 3 s, 7 s of idling: the leader's
    heartbeats keep the followers' waits short, and then it serves."""
    timeout_s, idle_s = 3.0, 7.0
    baskets = served["baskets"][:12]
    out = _spawn(ranks.mesh_gateway_idle, (2, 1), served["rb"][0], baskets, timeout_s, idle_s)
    assert [o["timeout_s"] for o in out] == [timeout_s, timeout_s]
    got, refs = out[0]["got"], out[0]["refs"]
    assert all(r is not None and r.generation == 0 for r in got)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.items, refs[r.bucket][0][i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), refs[r.bucket][1][i].view(np.uint32))


def test_a_dead_follower_fails_the_spawn_and_leaves_no_process(served, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 exited with code 3"):
        _spawn(ranks.mesh_gateway_dies, (1, 2), served["rb"][0], served["baskets"][:20], str(tmp_path),
               timeout_s=60.0)
    assert time.monotonic() - t0 < 60.0
    pids = [int((tmp_path / name).read_text()) for name in os.listdir(tmp_path)]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_one_rank_mesh_takes_the_single_device_path(served):
    baskets = served["baskets"][:20]
    (out,) = _spawn(ranks.one_rank_gateway, (1, 1), served["rb"][0], baskets)
    assert out["single"] and not out["failed"]
    for i, r in enumerate(out["got"]):
        want = recommend(served["rb"][0], baskets, top_k=TOP_K, batch_size=r.bucket, device="cpu")
        np.testing.assert_array_equal(r.items, want.items[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), want.scores[i].view(np.uint32))


# ------------------------------------------------------------------- F8 --
def _bit_for_bit(leader, responses, first=0):
    """Each response (basket ``first + i``) bit for bit the mesh
    ``recommend`` of its generation at its bucket, and not from the cache."""
    for i, r in enumerate(responses):
        assert not r.cached
        items, scores = leader["refs"][(r.generation, r.bucket)]
        np.testing.assert_array_equal(r.items, items[first + i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), scores[first + i].view(np.uint32))


def test_f8_requests_are_answered_by_the_old_generation_while_the_mine_is_held(on_2x3):
    """While the refresh's mine is held on every rank, every request
    submitted with a deadline is answered, before the refresh commits, by
    the serving generation, bit for bit its mesh ``recommend``; none
    expires or is rejected.  Then the refresh commits on every rank."""
    leader = on_2x3[0]
    held = leader["held"]
    assert held["failed"] == []   # no DeadlineExceeded, AdmissionRejected or unanswered request
    assert len(held["got"]) == ranks.HELD_REQUESTS and all(r is not None for r in held["got"])
    assert held["refresh_running"] and held["generation"] == held["before"] == 2 and held["cycles"] == 1
    assert {r.generation for r in held["got"]} == {2}
    _bit_for_bit(leader, held["got"])
    assert [o["held_refresh"] for o in on_2x3] == [4] * 6
    assert all(o["history_all"][1]["generation"] == 4 and o["history_all"][1]["mode"] == "delta"
               for o in on_2x3)


def test_f8_the_jax_gateway_answers_while_its_refresh_mines(served, tmp_path, monkeypatch):
    """The reference: JAX's ``Gateway`` + ``RefreshController``, its
    ``mine_delta`` held (patched here only), answer every request
    submitted with a deadline by generation 0, bit for bit JAX's
    ``recommend`` at the response's bucket; then the refresh commits."""
    from concurrent.futures import TimeoutError as NotYet

    from repro.serving.gateway import Gateway as JGateway
    from repro.serving.refresh import RefreshController as JRefreshController

    store = str(tmp_path / "store")
    shutil.copytree(served["jax_store"], store)
    jds.append_chunks([served["db"][:30]], store)
    entered, release = threading.Event(), threading.Event()
    mine_delta = jinc.mine_delta

    def held(*args, **kwargs):
        entered.set()
        assert release.wait(ranks.HOLD_S), "the test never released the mine"
        return mine_delta(*args, **kwargs)

    monkeypatch.setattr(jinc, "mine_delta", held)
    baskets = served["baskets"][: ranks.HELD_REQUESTS]
    gw = JGateway(served["jrb"][0], top_k=TOP_K, max_batch=MAX_BATCH, impl="jnp", max_wait_ms=2.0)
    try:
        ctl = JRefreshController(store, gw, JCFG, chunk_rows=64, min_confidence=0.4)
        box = {}
        refresher = threading.Thread(target=lambda: box.setdefault("generation", ctl.refresh_now()), daemon=True)
        refresher.start()
        assert entered.wait(ranks.HOLD_S)
        futs = [gw.submit(np.flatnonzero(b).tolist(), deadline_ms=ranks.HELD_DEADLINE_MS) for b in baskets]
        got, failed = [], []
        for f in futs:
            try:
                got.append(f.result(ranks.ANSWER_S))
            except NotYet:
                failed.append("not answered")
            except Exception as e:  # noqa: BLE001 — DeadlineExceeded, AdmissionRejected
                failed.append(repr(e))
        running, generation = refresher.is_alive(), gw.generation
        release.set()
        refresher.join(ranks.HOLD_S)
    finally:
        release.set()
        gw.close()
    assert failed == [] and running and generation == 0
    for i, r in enumerate(got):
        assert r.generation == 0 and not r.cached
        want = jrecommend(served["jrb"][0], baskets, top_k=TOP_K, batch_size=r.bucket, impl="jnp")
        np.testing.assert_array_equal(r.items, np.asarray(want.items)[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), np.asarray(want.scores)[i].view(np.uint32))
    assert box["generation"] == gw.generation == 1


def test_an_operator_swap_during_a_held_mine_takes_its_own_generation(on_2x3):
    """A hot swap lands while the refresh's mine is held (generation 3),
    is served at once, and the refresh's commit takes generation 4: the id
    is taken at the place, not at the mine's start."""
    leader = on_2x3[0]
    assert leader["held_swap"] == dict(value=3, returned_while_held=True)
    after = leader["held_after_swap"]
    assert after["failed"] == [] and after["refresh_running"]
    assert {r.generation for r in after["got"]} == {3}
    _bit_for_bit(leader, after["got"], first=ranks.HELD_REQUESTS)
    nxt = leader["held_next"]
    assert nxt["failed"] == [] and {r.generation for r in nxt["got"]} == {4}
    _bit_for_bit(leader, nxt["got"])
    # every rank answered every batch of the held cycles with one generation
    for other in on_2x3[1:]:
        assert other["answered_all"] == leader["answered_all"]
    assert {g for g, _ in leader["answered_all"]} == {0, 1, 2, 3, 4}


def test_a_mine_that_fails_on_one_follower_fails_the_cycle_on_every_rank(on_2x3):
    """The mine fails on rank 5 only: the leader's ``refresh_now`` and
    every follower's raise with rank 5's error, generation 4 serves on,
    and requests submitted while that mine was held were answered."""
    leader = on_2x3[0]
    failing = leader["failing"]
    assert failing["failed"] == [] and failing["refresh_running"]
    assert {r.generation for r in failing["got"]} == {4}
    _bit_for_bit(leader, failing["got"])
    assert leader["kept_after_failure"] == 4
    for per_rank in on_2x3:
        assert "the mine fails on rank 5 on purpose" in per_rank["failed_mine"]
        assert per_rank["history_all"][-1]["generation"] == 4
    assert "the refresh's mine failed on 1 rank(s)" in leader["failed_mine"]


def test_close_during_a_held_mine_returns_and_leaves_no_thread(on_2x3):
    """Rank 0 closes the gateway while the mine is held: its close returns
    at once and its refresh raises; each follower's refresh raises, its
    close waits for its mine thread, and no rank is left with a thread of
    the gateway or the controller.  (The spawn returning shows no rank's
    process is left.)"""
    leader = on_2x3[0]
    assert leader["closed_while_held"] and leader["close_s"] < ranks.CLOSE_RELEASE_S
    assert "the gateway is closed" in leader["closed_refresh"]
    for per_rank in on_2x3:
        assert per_rank["threads_after_close"] == []
    for follower in on_2x3[1:]:
        assert "follow loop ended before the refresh" in follower["closed_refresh"]


def test_the_mine_and_serving_never_share_a_group(on_2x3):
    """On every rank, every collective of the refresh's mine cycle went to
    the mine mesh's groups and every other collective to the gateway
    mesh's; none went to the default group, the two meshes share no group,
    and no two threads were ever in one group at once."""
    for per_rank in on_2x3:
        groups = per_rank["groups"]
        assert groups["mine"] > 0 and groups["serving"] > 0
        assert groups["wrong"] == [] and groups["overlaps"] == [] and groups["shared"] == []


def test_idle_refresh_groups_outlive_the_group_timeout(served):
    """Groups that time out after 3 s, 7 s of idling on both meshes: the mine
    mesh's groups, idle the whole time, still carry the delta mine (equal
    to JAX's ``mine_delta``), and its generation then serves."""
    timeout_s, idle_s = 3.0, 7.0
    out = _spawn(ranks.mesh_refresh_idle, (2, 1), served["rb"][0], served["baskets"][:12], served["idle_store"],
                 CFG, timeout_s, idle_s)
    for per_rank in out:
        assert per_rank["timeouts"] == (timeout_s, timeout_s)
        assert per_rank["refreshed"] == 1 and per_rank["mode"] == "delta"
        assert per_rank["result"] == served["jres2"]
    got, failed = out[0]["got"]
    assert not failed and all(r is not None and r.generation == 1 for r in got)
