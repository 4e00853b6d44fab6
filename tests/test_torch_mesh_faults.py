"""PyTorch port: one rank's failure on the mesh serving tier (module 7b)
costs what it costs in the JAX package — over spawned CPU ranks (gloo),
on meshes whose groups time out after 8 s.

F9: on a (2, 3) mesh (the 2,071-rule rulebook of
``test_torch_mesh_gateway.py``) batches fail on one rank or two: a
follower's ``Gateway._match`` raises before the batch's all-gathers, then
the leader's, then a follower's top-k between them, then two followers'
at once; later, under 4 clients, a follower fails one batch of several
requests.  Each failed batch fails exactly its own requests, each naming
the failed ranks and their errors, counted once in ``failed``; every other
request is answered bit for bit as the mesh ``recommend`` and within rtol
1e-5, atol 1e-6 of JAX's; every rank ran every batch; ``close()`` raises on
no rank.  Beside it the JAX reference: its ``Gateway`` answers every
request after a dispatch that raised.

F10: on a 2 x 2 mesh a follower raises inside level 2 of a delta refresh's
mine, between two of its collectives, while rank 0 sends requests.  The
cycle fails on every rank well before the groups' timeout, the generation
stays on every rank and answers; the next ``refresh_now`` commits on every
rank, dict-identical to JAX's ``mine_delta`` of a copy of the store; then
the same spawn fails and recovers once more (rows appended between).  The
mine mesh is replaced after each failed cycle.

F11: a follower's ``refresh_now`` returns once that generation's commit
has been applied there: ``refresh_now() == gw.generation`` on every rank
(rank 0's commits are delayed, so a follower returning at the place would
read the old generation).
"""

import shutil

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
from repro_torch.core.apriori import AprioriConfig  # noqa: E402
from repro_torch.data.store import open_store  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.serving.rulebook import rulebook_from_arrays  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
TOP_K, MAX_BATCH, CLIENTS = 5, 16, 4
GROUP_TIMEOUT_S = 8.0
DEADLINE_S = 90.0
JCFG = japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp", representation="packed")
CFG = AprioriConfig(min_support=0.04, max_k=4, representation="packed", data_axes=("data",),
                    model_axis="model")
# F9: batch (a call of every rank's _match) -> the ranks that fail it and where.
# Rank r sits at (r // 3, r % 3) of the (2, 3) mesh; the leader's answer
# reads every rank's rule block and the top-k of ranks 0 and 3 (its data
# group), so a top-k failing on rank 2 (batch 15) changes nothing it returns.
BATCH_PLAN = {3: {4: "match"}, 6: {0: "match"}, 9: {3: "topk"}, 12: {1: "match", 5: "match"},
              15: {2: "topk"}, 24: {3: "match"}}
UNREAD = {15}   # the batches whose failure the leader's answer never reads
FAILING_RANK = 3   # F10: the follower whose mine fails


def _spawn(fn, shape, *args):
    return spawn(fn, shape, ("data", "model"), device="cpu", backend="gloo", timeout_s=DEADLINE_S, args=args)


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


def _bit_for_bit(r, ref, i):
    items, scores = ref
    np.testing.assert_array_equal(r.items, items[i])
    np.testing.assert_array_equal(r.scores.view(np.uint32), scores[i].view(np.uint32))


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    """The DB and generation-0 rulebook of ``test_torch_mesh_gateway.py``; a
    store of the DB with its count cache and 40 appended rows; and JAX's
    ``mine_delta`` of a copy of that store, then of the copy with 30 more
    rows appended (the rows the F10 spawn appends before its third cycle)."""
    db = gen_transactions(QuestConfig(num_transactions=400, num_items=64, avg_len=8, seed=13))
    extra = gen_transactions(QuestConfig(num_transactions=40, num_items=64, avg_len=8, seed=14))
    res0 = japr.mine(db, japr.AprioriConfig(min_support=0.04, max_k=4, count_impl="jnp"))
    jrb = jcompile(res0, min_confidence=0.4, num_items=64, pad_multiple=8)
    rb = rulebook_from_arrays(jrb.ante_packed, jrb.cons_packed, jrb.ante_len, jrb.scores, jrb.num_items,
                              jrb.score_kind, jrb.min_confidence)
    root = tmp_path_factory.mktemp("mesh-faults")
    store, jax_store = str(root / "store"), str(root / "jax-store")
    jds.ingest_dense(db, store, shard_rows=100)
    shutil.copytree(store, jax_store)
    inc.build_count_cache(open_store(store), CFG, "cpu", chunk_rows=64)
    jinc.build_count_cache(jds.open_store(jax_store), JCFG, chunk_rows=64)
    for path in (store, jax_store):
        jds.append_chunks([extra], path)
    appended = db[:30]
    jres = [jinc.mine_delta(jds.open_store(jax_store), JCFG, chunk_rows=64)[0].as_dict()]
    jds.append_chunks([appended], jax_store)
    jres.append(jinc.mine_delta(jds.open_store(jax_store), JCFG, chunk_rows=64)[0].as_dict())
    return dict(db=db, baskets=db[:90], jrb=jrb, rb=rb, store=store, appended=appended, jres=jres)


# ------------------------------------------------------------------- F9 --
@pytest.fixture(scope="module")
def batches(faults):
    return _spawn(ranks.mesh_failing_batches, (2, 3), faults["rb"], faults["baskets"], TOP_K, MAX_BATCH,
                  GROUP_TIMEOUT_S, BATCH_PLAN, CLIENTS)


def test_f9_a_failed_batch_fails_only_its_requests_naming_the_ranks(batches):
    """Sent one at a time, request i rides batch i + 1: the batches of the
    plan fail their one request each, naming every failed rank and its
    error, and no other request fails.  A rank off the leader's data group
    whose top-k fails (batch 15) computed rows nobody reads: that batch is
    answered, bit for bit (the next test)."""
    alone = batches[0]["alone"]
    assert len(alone) == 15
    for i, r in enumerate(alone):
        failing = BATCH_PLAN.get(i + 1)
        if failing is None or i + 1 in UNREAD:
            assert not isinstance(r, str), f"request {i}: {r}"
            continue
        assert isinstance(r, str) and f"the batch failed on {len(failing)} rank(s)" in r
        for rank, where in failing.items():
            assert f"rank {rank}: " in r
            words = "before its all-gathers" if where == "match" else "between its all-gathers"
            assert f"batch {i + 1} fails on rank {rank} {words}" in r


def test_f9_under_load_one_batch_of_several_requests_fails_and_is_counted_once(batches):
    """Under 4 clients a follower fails one batch: its requests (more than
    one) fail naming rank 3, the gateway's ``failed`` counts each failed
    request once, and every other request is answered."""
    leader = batches[0]
    together = [r for c in leader["together"] for r in c]
    failed = [r for r in together if isinstance(r, str)]
    assert len(failed) > 1 and all("rank 3: " in r and "batch 24 fails on rank 3" in r for r in failed)
    failed_alone = sum(isinstance(r, str) for r in leader["alone"])
    assert failed_alone == len(BATCH_PLAN) - len(UNREAD) - 1
    assert leader["failed_metric"] == failed_alone + len(failed)


def test_f9_every_other_request_is_bit_for_bit_the_mesh_recommend(batches, faults):
    leader = batches[0]
    n_alone = len(leader["alone"])
    clients = leader["together"]
    answered = [(i, r) for i, r in enumerate(leader["alone"]) if not isinstance(r, str)]
    for c, responses in enumerate(clients):
        answered += [(n_alone + c + j * CLIENTS, r) for j, r in enumerate(responses) if not isinstance(r, str)]
    assert len(answered) > 60
    want = jrecommend(faults["jrb"], faults["baskets"], top_k=TOP_K, batch_size=30, impl="jnp")
    for i, r in answered:
        assert r.generation == 0 and not r.cached
        _bit_for_bit(r, leader["refs"][r.bucket], i)
        _held(r.items, r.scores, np.asarray(want.items)[i], np.asarray(want.scores)[i])


def test_f9_every_rank_stays_in_step_and_closes(batches):
    """Every rank ran every batch of the stream (its ``_match`` called once
    a batch, failed or not) and closed without an error."""
    for per_rank in batches:
        assert per_rank["closed"] is True
        assert per_rank["batches"] == per_rank["calls"] == batches[0]["batches"]
    assert batches[0]["batches"] > max(BATCH_PLAN)


def test_f9_the_jax_gateway_answers_after_a_dispatch_that_raised(faults, monkeypatch):
    """The reference: JAX's ``Gateway`` whose match raises once fails that
    request only and answers the next ones, bit for bit JAX's
    ``recommend`` at the response's bucket."""
    from repro.serving.gateway import Gateway as JGateway

    match, calls = JGateway._match, []

    def failing(gw, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("the dispatch fails once")
        return match(gw, *args)

    baskets = faults["baskets"][:6]
    with JGateway(faults["jrb"], top_k=TOP_K, max_batch=MAX_BATCH, impl="jnp", max_wait_ms=0.0) as gw:
        monkeypatch.setattr(JGateway, "_match", failing)   # after the warm-up's matches
        got = []
        for b in baskets:
            try:
                got.append(gw.query(np.flatnonzero(b).tolist(), timeout=30))
            except RuntimeError as e:
                got.append(str(e))
        failed = gw.metrics.failed
    assert got[2] == "the dispatch fails once" and failed == 1
    for i, r in enumerate(got):
        if i == 2:
            continue
        want = jrecommend(faults["jrb"], baskets, top_k=TOP_K, batch_size=r.bucket, impl="jnp")
        np.testing.assert_array_equal(r.items, np.asarray(want.items)[i])
        np.testing.assert_array_equal(r.scores.view(np.uint32), np.asarray(want.scores)[i].view(np.uint32))


# ------------------------------------------------------------ F10, F11 --
@pytest.fixture(scope="module")
def refreshes(faults, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("f10") / "store")
    shutil.copytree(faults["store"], store)
    return _spawn(ranks.mesh_failing_refresh, (2, 2), faults["rb"], faults["baskets"], store, CFG,
                  GROUP_TIMEOUT_S, str(tmp_path_factory.mktemp("f10-hold")), FAILING_RANK, faults["appended"])


def test_f10_a_mine_failing_inside_level_2_fails_the_cycle_on_every_rank(refreshes):
    """Cycles 1 and 3 fail on every rank with rank 3's error, each well
    before the groups' timeout (the abort released the ranks waiting in
    the mine's collectives), and every rank keeps its generation."""
    for per_rank in refreshes:
        for n, kept in ((0, 0), (2, 1)):
            cycle = per_rank["cycles"][n]
            assert cycle.get("value") is None and cycle["generation"] == kept
            assert f"mine {n + 1} fails on rank {FAILING_RANK} inside level 2" in cycle["error"]
    for n in (0, 2):
        assert refreshes[0]["cycles"][n]["fail_s"] < GROUP_TIMEOUT_S


def test_f10_the_old_generation_answers_during_and_after_a_failed_cycle(refreshes):
    """Requests sent while the failing mine is held, and after the cycle
    failed, are answered by the serving generation, bit for bit its mesh
    ``recommend``, none failed or expired."""
    leader = refreshes[0]
    for n, generation in ((0, 0), (2, 1)):
        cycle = leader["cycles"][n]
        for first, (got, failed) in ((0, cycle["held"]), (8, cycle["after"])):
            assert failed == [] and len(got) == 8
            for i, r in enumerate(got):
                assert r.generation == generation and not r.cached
                _bit_for_bit(r, leader["refs"][(r.generation, r.bucket)], first + i)


def test_f10_the_next_refresh_commits_on_every_rank_as_jax_mine_delta(refreshes, faults):
    """Cycles 2 and 4 commit generations 1 and 2 on every rank, each
    dict-identical to JAX's ``mine_delta`` of a copy of the store, and the
    new generation answers."""
    for per_rank in refreshes:
        assert [c.get("value") for c in per_rank["cycles"]] == [None, 1, None, 2]
        assert per_rank["results"] == faults["jres"]
        assert [h["generation"] for h in per_rank["history"]] == [1, 2]
        assert [h["mode"] for h in per_rank["history"]] == ["delta", "delta"]
        assert per_rank["threads_after_close"] == []
    got, failed = refreshes[0]["last"]
    assert failed == [] and {r.generation for r in got} == {2}
    for i, r in enumerate(got):
        _bit_for_bit(r, refreshes[0]["refs"][(r.generation, r.bucket)], i)


def test_f10_a_failed_cycle_replaces_the_mine_mesh_on_every_rank(refreshes):
    """The mine mesh is replaced after each failed cycle (and only then),
    on every rank alike."""
    groups = refreshes[0]["mine_groups"]
    assert groups[0] != groups[1] == groups[2] != groups[3] == groups[4]
    for per_rank in refreshes[1:]:
        assert per_rank["mine_groups"] == groups


def test_f11_refresh_now_returns_the_generation_that_serves_on_every_rank(refreshes):
    for per_rank in refreshes:
        for cycle in per_rank["cycles"]:
            if cycle.get("value") is not None:
                assert cycle["value"] == cycle["generation"], per_rank["rank"]
