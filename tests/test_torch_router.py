"""PyTorch port: the replicated serving tier on the CPU.

Mirrors ``tests/test_router.py``.  The routed-request contract under chaos:
every admitted request reaches EXACTLY ONE terminal outcome — a Response
bit-identical to the port's ``recommend()`` against the generation that
answered it, or a typed ``DeadlineExceeded`` / ``AdmissionRejected`` /
``WorkerCrashed`` — with zero hung futures and zero mixed-generation
batches, while replicas are being killed (the batcher's crash hook),
delayed, and hot-swapped underneath.  Attempt timeouts and deadlines here
are 2 s or more, so a loaded test machine cannot fail a healthy attempt.
"""

import functools
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro_torch.distributed import FaultConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionRejected,
    DeadlineExceeded,
    WorkerCrashed,
    compile_rulebook,
)
from repro_torch.serving import Router as _Router  # noqa: E402
from repro_torch.serving import recommend as _recommend  # noqa: E402
from repro_torch.serving.router import DEAD, HEALTHY, SUSPECT, HashRing  # noqa: E402

Router = functools.partial(_Router, device="cpu")
recommend = functools.partial(_recommend, device="cpu")

# killing dispatch workers IS the subject under test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

NUM_ITEMS = 32


@pytest.fixture(scope="module")
def rulebooks(small_db):
    from repro_torch.core.apriori import AprioriConfig, mine

    cfg = functools.partial(AprioriConfig, max_k=3, representation="packed")
    rb0 = compile_rulebook(
        mine(small_db, cfg(min_support=0.05), device="cpu"),
        min_confidence=0.3, num_items=NUM_ITEMS,
    )
    rb1 = compile_rulebook(
        mine(small_db, cfg(min_support=0.12), device="cpu"),
        min_confidence=0.5, num_items=NUM_ITEMS,
    )
    assert rb0.num_rules > rb1.num_rules > 0
    return rb0, rb1


def fresh_baskets(n, seed):
    rng = np.random.default_rng(seed)
    return [
        sorted(rng.choice(NUM_ITEMS, size=int(rng.integers(1, 7)),
                          replace=False).tolist())
        for _ in range(n)
    ]


def check_response(resp, rb, basket, top_k):
    """Bit-identity vs the direct batch engine at the answering bucket."""
    direct = recommend(rb, [basket], top_k=top_k, batch_size=resp.bucket)
    assert np.array_equal(resp.items, direct.items[0])
    assert np.array_equal(resp.scores, direct.scores[0])


def _wait_until(pred, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ------------------------------------------------------------------ ring --
def test_ring_deterministic_and_balanced():
    a, b = HashRing(4, vnodes=64), HashRing(4, vnodes=64)
    counts = [0] * 4
    for i in range(2000):
        key = f"basket-{i}".encode()
        pref = a.preference(key)
        assert pref == b.preference(key)          # stable across instances
        assert sorted(pref) == [0, 1, 2, 3]       # every replica, owner first
        counts[pref[0]] += 1
    assert min(counts) >= 0.05 * 2000             # no starved replica


def test_ring_stability_under_replica_loss():
    """Consistent hashing: removing the last replica only moves the keys it
    owned — everyone else's baskets (and caches) stay put."""
    big, small = HashRing(4, vnodes=64), HashRing(3, vnodes=64)
    moved = kept = 0
    for i in range(2000):
        key = f"basket-{i}".encode()
        if big.owner(key) == 3:
            moved += 1
        else:
            assert small.owner(key) == big.owner(key)
            kept += 1
    assert moved > 0 and kept > 0


def test_ring_failover_order_is_a_rotation_start():
    ring = HashRing(5, vnodes=32)
    pref = ring.preference(b"some basket")
    assert pref[0] == ring.owner(b"some basket")
    assert len(set(pref)) == 5


# -------------------------------------------------------------- baseline --
def test_single_replica_parity(rulebooks):
    rb0, _ = rulebooks
    with Router(rb0, 1, warmup=False, max_wait_ms=0.0) as r:
        for basket in fresh_baskets(24, seed=0):
            resp = r.query(basket, timeout=30)
            assert resp.generation == 0
            check_response(resp, rb0, basket, r.default_top_k)
        s = r.stats()
        assert s["routed"] == 24
        assert s["completed"] >= 24 - s["failed"]


def test_sticky_routing_keeps_caches_effective(rulebooks):
    """A repeat basket lands on the same replica and hits its exact-basket
    LRU — the consistent-hashing cache argument."""
    rb0, _ = rulebooks
    with Router(rb0, 3, warmup=False, max_wait_ms=0.0) as r:
        basket = [1, 4, 9]
        first = r.query(basket, timeout=30)
        assert not first.cached
        second = r.query(basket, timeout=30)
        assert second.cached
        check_response(second, rb0, basket, r.default_top_k)
        # exactly one replica saw the basket: one cache holds one entry
        sizes = [rep.gateway.cache.snapshot()["size"] for rep in r._replicas]
        assert sorted(sizes) == [0, 0, 1]


# -------------------------------------------------------------- failover --
def test_failover_on_worker_kill(rulebooks):
    """Kill every replica's worker mid-batch: the supervisor revives them,
    failed attempts re-route, and EVERY request still resolves correctly."""
    rb0, _ = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                attempt_timeout_s=5.0,
                fault=FaultConfig(max_retries=3, backoff_s=0.01)) as r:
        r.query(fresh_baskets(1, seed=9)[0], timeout=30)   # warm off-path
        r.fault_injection.kill_replica(0)
        r.fault_injection.kill_replica(1)
        baskets = fresh_baskets(40, seed=1)
        futs = [r.submit(b) for b in baskets]
        for b, f in zip(baskets, futs):
            check_response(f.result(timeout=30), rb0, b, r.default_top_k)
        assert r.fault_injection.kills_fired == 2
        assert sum(r.supervisor.stats()["restarts"]) >= 2
        assert r.metrics.failovers >= 1


def test_storming_replica_declared_dead_traffic_continues(rulebooks):
    """A replica whose worker crashes on EVERY dispatch exhausts its restart
    budget, is declared dead (typed rejects already failed its in-flight
    work), and the surviving replica keeps answering everything."""
    rb0, _ = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                attempt_timeout_s=5.0, max_restarts=3, restart_window_s=30.0,
                fault=FaultConfig(max_retries=4, backoff_s=0.01)) as r:
        r.query(fresh_baskets(1, seed=9)[0], timeout=30)
        # always-crash hook on replica 0 (overrides the injection hook)
        r._replicas[0].gateway._batcher._crash_hook = (
            lambda batch: (_ for _ in ()).throw(SystemExit("poisoned"))
        )
        # sustained traffic: each wave re-feeds the poisoned worker until
        # the restart budget is exhausted and the replica is declared dead
        outcomes = []
        wave = 0
        give_up_at = time.perf_counter() + 30.0
        while r._replicas[0].state != DEAD and time.perf_counter() < give_up_at:
            for b in fresh_baskets(8, seed=200 + wave):
                try:
                    outcomes.append((b, r.submit(b)))
                except AdmissionRejected as e:
                    outcomes.append((b, e))
            wave += 1
            time.sleep(0.05)
        terminal = []
        for b, item in outcomes:
            if isinstance(item, Exception):
                terminal.append((b, item))
                continue
            try:
                terminal.append((b, item.result(timeout=30)))
            except (WorkerCrashed, AdmissionRejected, DeadlineExceeded) as e:
                terminal.append((b, e))
        assert r._replicas[0].state == DEAD
        assert r.metrics.replica_deaths == 1
        assert r.supervisor.stats()["dead"] == [True, False]
        ok = [(b, x) for b, x in terminal if not isinstance(x, Exception)]
        assert len(ok) > 0
        for b, resp in ok:
            check_response(resp, rb0, b, r.default_top_k)
        # the survivor still answers everything after the death
        for b in fresh_baskets(10, seed=3):
            check_response(r.query(b, timeout=30), rb0, b, r.default_top_k)
        assert r.stats()["replicas"][0]["state"] == "dead"


# -------------------------------------------------------------- deadlines --
def test_router_deadline_on_unresponsive_replicas(rulebooks):
    """Both replicas delayed past the deadline: the router's watchdog fails
    the outer future with DeadlineExceeded — a slow replica cannot hold a
    client past its deadline."""
    rb0, _ = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                attempt_timeout_s=2.0,
                fault=FaultConfig(max_retries=2, backoff_s=0.01)) as r:
        r.query(fresh_baskets(1, seed=9)[0], timeout=30)
        r.fault_injection.delay_replica(0, 3.0)
        r.fault_injection.delay_replica(1, 3.0)
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceeded):
            r.query(fresh_baskets(1, seed=4)[0], deadline_ms=2000, timeout=30)
        assert time.perf_counter() - t0 < 20.0
        assert r.metrics.deadline_failed == 1
        r.fault_injection.delay_replica(0, 0.0)
        r.fault_injection.delay_replica(1, 0.0)


def test_generous_deadline_served_normally(rulebooks):
    rb0, _ = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0) as r:
        basket = fresh_baskets(1, seed=5)[0]
        resp = r.query(basket, deadline_ms=30_000, timeout=30)
        check_response(resp, rb0, basket, r.default_top_k)
        assert r.metrics.deadline_failed == 0


# ---------------------------------------------------------- load shedding --
def test_load_shedding_typed_reject_when_saturated(rulebooks):
    """Every candidate's admission queue full ⇒ a typed AdmissionRejected
    at submit, counted as shed — overload is loud, never a silent drop."""
    rb0, _ = rulebooks
    with Router(rb0, 1, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                max_batch=1, queue_depth=2, supervise=False,
                fault=FaultConfig(max_retries=0, backoff_s=0.01)) as r:
        r.query(fresh_baskets(1, seed=9)[0], timeout=30)
        r.fault_injection.delay_replica(0, 0.4)
        baskets = fresh_baskets(32, seed=6)
        futs, shed = [], 0
        for b in baskets:
            try:
                futs.append(f := r.submit(b))
            except AdmissionRejected:
                shed += 1
        assert shed > 0
        assert r.metrics.shed == shed
        r.fault_injection.delay_replica(0, 0.0)
        for f in futs:       # admitted ⇒ resolved, even through the delay
            try:
                f.result(timeout=30)
            except (WorkerCrashed, DeadlineExceeded, AdmissionRejected):
                pass


def test_closed_router_rejects(rulebooks):
    rb0, _ = rulebooks
    r = Router(rb0, 1, warmup=False, supervise=False)
    r.close()
    with pytest.raises(AdmissionRejected):
        r.submit([1, 2, 3])


# ------------------------------------------------------ two-phase hot-swap --
def test_coordinated_swap_flips_every_replica(rulebooks):
    rb0, rb1 = rulebooks
    with Router(rb0, 3, warmup=False, max_wait_ms=0.0) as r:
        gen = r.hot_swap(rb1)
        assert gen == 1
        assert [rep.gateway.generation for rep in r._replicas] == [1, 1, 1]
        assert r.metrics.coordinated_swaps == 1
        assert r.metrics.swap_prepare_failures == 0
        for basket in fresh_baskets(12, seed=7):
            resp = r.query(basket, timeout=30)
            assert resp.generation == 1
            check_response(resp, rb1, basket, r.default_top_k)
        assert r.metrics.max_generation_lag == 0


def test_failed_prepare_stale_generation_then_resync(rulebooks):
    """Replica 1 fails phase-1 prepare: the swap still commits on replica 0,
    replica 1 keeps answering the STALE generation (lag tracked), and once
    the failure clears the monitor re-syncs it to the coordinated id."""
    rb0, rb1 = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0,
                monitor_interval_s=0.01) as r:
        r.fault_injection.fail_swap_on(1)
        gen = r.hot_swap(rb1)
        assert gen == 1
        assert r._replicas[0].gateway.generation == 1
        assert r._replicas[1].gateway.generation == 0     # stale, still serving
        assert r.metrics.swap_prepare_failures == 1
        assert r._replicas[1].state == SUSPECT
        assert _wait_until(lambda: r.metrics.max_generation_lag >= 1)

        # the stale replica still answers ITS generation bit-correctly
        for basket in fresh_baskets(16, seed=8):
            resp = r.query(basket, timeout=30)
            assert resp.generation in (0, 1)
            check_response(resp, (rb0, rb1)[resp.generation], basket,
                           r.default_top_k)

        r.fault_injection.clear_swap_failures()
        assert _wait_until(lambda: r._replicas[1].gateway.generation == 1)
        assert r.metrics.resyncs >= 1
        assert _wait_until(lambda: r._replicas[1].state == HEALTHY)
        assert _wait_until(
            lambda: r.stats()["current_generation_lag"] == 0)
        resp = r.query(fresh_baskets(1, seed=9)[0], timeout=30)
        assert resp.generation == 1


def test_swap_with_no_preparable_replica_raises(rulebooks):
    rb0, rb1 = rulebooks
    with Router(rb0, 2, warmup=False, supervise=False) as r:
        r.fault_injection.fail_swap_on(0)
        r.fault_injection.fail_swap_on(1)
        with pytest.raises(RuntimeError):
            r.hot_swap(rb1)
        assert r.generation == 0          # nothing committed anywhere
        assert [rep.gateway.generation for rep in r._replicas] == [0, 0]


# ------------------------------------------------------------------ chaos --
def test_chaos_exactly_one_terminal_outcome_per_request(rulebooks):
    """Random replica kills + delays + concurrent coordinated hot-swaps +
    bursty submits from 4 client threads. Every request must reach exactly
    one terminal outcome: a bit-correct Response for the generation that
    answered it, or a typed DeadlineExceeded / AdmissionRejected /
    WorkerCrashed. Zero hung futures, zero mixed-generation answers, and
    routed == completed + failed at the end."""
    rb0, rb1 = rulebooks
    gens = {0: rb0}
    r = Router(
        rb0, 3, warmup=False, max_wait_ms=0.0, max_batch=16,
        cache_capacity=128, attempt_timeout_s=2.0,
        fault=FaultConfig(max_retries=3, backoff_s=0.01),
        max_restarts=50, restart_window_s=60.0, monitor_interval_s=0.01,
    )
    r.query([1, 2, 3], timeout=30)        # first warm-up off the clock

    outcomes: list = []
    out_lock = threading.Lock()
    stop = threading.Event()

    def submitter(seed, n):
        rng = np.random.default_rng(seed)
        for _ in range(n):
            basket = sorted(rng.choice(
                NUM_ITEMS, size=int(rng.integers(1, 7)), replace=False
            ).tolist())
            deadline_ms = (None if rng.random() < 0.7
                           else float(rng.integers(2000, 4000)))
            try:
                item = r.submit(basket, deadline_ms=deadline_ms)
            except AdmissionRejected as e:
                item = e
            with out_lock:
                outcomes.append((basket, item))
            if rng.random() < 0.25:
                time.sleep(0.002)          # bursts with occasional gaps

    threads = [threading.Thread(target=submitter, args=(100 + i, 60))
               for i in range(4)]
    for t in threads:
        t.start()

    chaos_rng = np.random.default_rng(0xC1A05)
    next_rb = [rb1]
    while any(t.is_alive() for t in threads):
        roll = chaos_rng.random()
        if roll < 0.40:
            r.fault_injection.kill_replica(int(chaos_rng.integers(0, 3)))
        elif roll < 0.55:
            rid = int(chaos_rng.integers(0, 3))
            r.fault_injection.delay_replica(rid, 0.08)
            time.sleep(0.02)
            r.fault_injection.delay_replica(rid, 0.0)
        elif roll < 0.75:
            try:
                new_gen = r.hot_swap(next_rb[0])
                gens[new_gen] = next_rb[0]
                next_rb[0] = rb0 if next_rb[0] is rb1 else rb1
            except RuntimeError:
                pass                       # no preparable replica right now
        time.sleep(0.02)
    for t in threads:
        t.join()
    stop.set()

    # ---- every request: exactly one typed terminal outcome, no hangs -----
    terminal = []
    for basket, item in outcomes:
        if isinstance(item, Exception):
            terminal.append((basket, item))
            continue
        try:
            terminal.append((basket, item.result(timeout=30)))   # no hangs
        except (DeadlineExceeded, AdmissionRejected, WorkerCrashed) as e:
            terminal.append((basket, e))
    assert len(terminal) == 240

    ok = [(b, x) for b, x in terminal if not isinstance(x, Exception)]
    failed = [(b, x) for b, x in terminal if isinstance(x, Exception)]
    # chaos must not take the service down: the vast majority still answers
    assert len(ok) >= 120
    for basket, resp in ok:
        # zero mixed generations: the response names ONE swapped-in
        # generation and is bit-identical to recommend() against it
        assert resp.generation in gens
        check_response(resp, gens[resp.generation], basket, r.default_top_k)

    m = r.metrics
    assert _wait_until(lambda: m.routed == m.completed + m.failed)
    assert m.completed == len(ok) + 1     # +1: the pre-chaos warm-up query
    s = r.stats()
    assert s["routed"] == s["completed"] + s["failed"]
    r.close()
    # after close everything is drained; nothing new is admitted
    with pytest.raises(AdmissionRejected):
        r.submit([1, 2])


# ----------------------------------------------- alert reactions (§14) ----
def _alert(signal, severity):
    from repro_torch.obs import AlertEvent

    return AlertEvent(slo=f"{signal}_spec", signal=signal, kind="error_ratio",
                      severity=severity, previous="ok", burn_rate=20.0,
                      window_s=2.0, value=0.5, objective=0.999,
                      t_wall=0.0, message="test")


def test_brownout_sheds_early_and_lifts_on_clear(rulebooks):
    """An availability alert tightens admission: at level 2 (page) the
    router sheds once aggregate queue fill crosses 25% of capacity, with a
    typed reject naming the brownout; the clear lifts it."""
    rb0, _ = rulebooks
    with Router(rb0, 1, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                max_batch=1, queue_depth=4, supervise=False,
                fault=FaultConfig(max_retries=0, backoff_s=0.01)) as r:
        r.query(fresh_baskets(1, seed=20)[0], timeout=30)   # warm the path
        assert r.brownout_level == 0
        r.handle_alert(_alert("availability", "page"))
        assert r.brownout_level == 2

        r.fault_injection.delay_replica(0, 0.3)
        futs, brownout_sheds = [], 0
        for b in fresh_baskets(16, seed=21):
            try:
                futs.append(r.submit(b))
            except AdmissionRejected as e:
                assert "brownout" in str(e)
                brownout_sheds += 1
        # 25% of a 4-deep queue = 1 slot: the burst must shed early, long
        # before the queue itself would have rejected anything
        assert brownout_sheds > 0
        assert r.metrics.brownout_sheds == brownout_sheds
        assert r.metrics.shed >= brownout_sheds     # counted as shed too
        r.fault_injection.delay_replica(0, 0.0)
        for f in futs:
            f.result(timeout=30)

        r.handle_alert(_alert("availability", "ok"))
        assert r.brownout_level == 0
        assert r.query(fresh_baskets(1, seed=22)[0], timeout=30) is not None
        assert r.stats()["brownout_level"] == 0


def test_brownout_warn_level_is_looser_than_page(rulebooks):
    rb0, _ = rulebooks
    with Router(rb0, 1, warmup=False, supervise=False) as r:
        r.handle_alert(_alert("availability", "warn"))
        assert r.brownout_level == 1
        r.handle_alert(_alert("availability", "page"))
        assert r.brownout_level == 2


def test_generation_lag_alert_forces_immediate_resync(rulebooks):
    """With the background monitor effectively disabled, a lag alert is the
    ONLY thing that can re-sync a stale replica — handle_alert must do it."""
    rb0, rb1 = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0,
                monitor_interval_s=3600.0, supervise=False) as r:
        r.fault_injection.fail_swap_on(1)
        assert r.hot_swap(rb1) == 1
        assert r._replicas[1].gateway.generation == 0       # stale
        r.fault_injection.clear_swap_failures()

        r.handle_alert(_alert("generation_lag", "page"))
        assert r._replicas[1].gateway.generation == 1       # caught up NOW
        assert r.metrics.alert_resyncs == 1
        assert r.stats()["current_generation_lag"] == 0


def test_unknown_alert_signal_is_ignored(rulebooks):
    rb0, _ = rulebooks
    with Router(rb0, 1, warmup=False, supervise=False) as r:
        r.handle_alert(_alert("vibes", "page"))
        assert r.brownout_level == 0
        assert r.metrics.alert_resyncs == 0


def test_healthy_ratio_gauge_dips_through_kill_then_recovers(rulebooks):
    """The gauge the replica_availability SLO watches: a replica kill must
    hold the ratio below 1.0 for at least the suspect window (so a sampling
    evaluator can SEE it), then return to 1.0 after supervised recovery."""
    rb0, _ = rulebooks
    # a suspect window of 3 s: a loaded machine cannot run past the dip
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0, cache_capacity=0,
                monitor_interval_s=0.01, healthy_after_s=3.0,
                fault=FaultConfig(max_retries=3, backoff_s=0.01)) as r:
        assert r.metrics.healthy_replica_ratio == 1.0
        r.fault_injection.kill_replica(0)
        futs = [r.submit(b) for b in fresh_baskets(8, seed=23)]   # trigger the armed kill
        assert _wait_until(lambda: r.metrics.healthy_replica_ratio < 1.0, 10.0)
        for f in futs:
            f.result(timeout=30)
        assert r.fault_injection.kills_fired == 1
        assert _wait_until(lambda: r.metrics.healthy_replica_ratio == 1.0, 30.0)
        assert _wait_until(lambda: all(rep.state == HEALTHY
                                       for rep in r._replicas), 30.0)
        # the gauge rides the registry too (the SLO evaluator's input)
        assert r.metrics.registry.raw_snapshot()[
            "router_healthy_replica_ratio"] == 1.0


def test_router_generation_age_resets_on_coordinated_swap(rulebooks):
    rb0, rb1 = rulebooks
    with Router(rb0, 2, warmup=False, max_wait_ms=0.0, supervise=False) as r:
        time.sleep(0.05)
        pre_swap = r.metrics.generation_age.value
        assert pre_swap >= 0.05
        r.hot_swap(rb1)
        assert r.metrics.generation_age.value < pre_swap
        assert r.metrics.registry.raw_snapshot()[
            "router_generation_age_seconds"] < pre_swap


# ------------------------------------------------- the port's own contract --
def test_replicas_each_place_their_own_rulebook(rulebooks):
    """N replicas are N gateways on the one device, each with its own
    placed copy of the rulebook (and of every swapped-in generation)."""
    rb0, rb1 = rulebooks
    with Router(rb0, 3, warmup=False, max_wait_ms=0.0, supervise=False) as r:
        placed = [rep.gateway._generation.rulebook for rep in r._replicas]
        assert all(p.device.type == "cpu" for p in placed)
        assert len({id(p.ante_packed) for p in placed}) == 3
        r.hot_swap(rb1)
        placed = [rep.gateway._generation.rulebook for rep in r._replicas]
        assert len({id(p.scores) for p in placed}) == 3
        for b in fresh_baskets(6, seed=31):
            check_response(r.query(b, timeout=30), rb1, b, r.default_top_k)


def test_stats_keys_match_jax_router(rulebooks, small_db):
    from repro.core.apriori import AprioriConfig as JConfig
    from repro.core.apriori import mine as jmine
    from repro.serving import Router as JRouter
    from repro.serving import compile_rulebook as jcompile

    jbook = jcompile(jmine(small_db, JConfig(min_support=0.05, max_k=3, count_impl="jnp")),
                     min_confidence=0.3, num_items=NUM_ITEMS)
    with JRouter(jbook, 2, impl="jnp", warmup=False, supervise=False) as jr, \
            Router(rulebooks[0], 2, warmup=False, supervise=False) as tr:
        b = fresh_baskets(1, seed=40)[0]
        jr.query(b, timeout=30)
        tr.query(b, timeout=30)
        js, ts = jr.stats(), tr.stats()
        assert sorted(ts) == sorted(js)
        assert sorted(ts["replicas"][0]) == sorted(js["replicas"][0])
        assert sorted(tr.metrics.registry.snapshot()) == sorted(jr.metrics.registry.snapshot())
