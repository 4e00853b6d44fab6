"""PyTorch port: the serving gateway on the CPU, held to the port's own
``recommend`` and against the JAX package's gateway.

Mirrors ``tests/test_gateway.py``: bit-identity under any arrival
interleaving, hot-swap with zero dropped / zero mixed-generation requests,
backpressure reporting, cache semantics, metrics arithmetic and deadlines.
The port's contract: a gateway response equals the port's ``recommend()``
against the generation named in the response at the answering bucket
(``batch_size=resp.bucket``), bit for bit.  Against the JAX gateway on the
same rulebook (carried across with ``rulebook_from_arrays``) scores agree
within rtol=1e-5, atol=1e-6, and items agree except within that tolerance
of a tie.
"""

import functools
import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro_torch.serving import (  # noqa: E402
    AdmissionRejected,
    BasketCache,
    GatewayMetrics,
    LatencyHistogram,
    MicroBatcher,
    Request,
    basket_key,
    compile_rulebook,
    pow2_bucket,
)
from repro_torch.serving import Gateway as _Gateway  # noqa: E402
from repro_torch.serving import recommend as _recommend  # noqa: E402

# every gateway and direct call here runs on the CPU, as the caller must ask
Gateway = functools.partial(_Gateway, device="cpu")
recommend = functools.partial(_recommend, device="cpu")

RTOL, ATOL = 1e-5, 1e-6

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


@pytest.fixture(scope="module")
def baskets(small_db):
    return [np.flatnonzero(row).tolist() for row in small_db[:64]]


def check_response(resp, rb, basket, top_k):
    """One response vs the direct batch engine at the answering bucket."""
    direct = recommend(rb, [basket], top_k=top_k, batch_size=resp.bucket)
    assert np.array_equal(resp.items, direct.items[0])
    assert np.array_equal(resp.scores, direct.scores[0])


# ------------------------------------------------------------ bit-identity --
def test_sequential_singles_match_recommend(rulebooks, baskets):
    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=8, max_wait_ms=0.0, cache_capacity=0) as gw:
        for b in baskets[:10]:
            resp = gw.query(b, top_k=5)
            assert resp.generation == 0 and not resp.cached
            check_response(resp, rb0, b, 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interleavings_bit_identical(rulebooks, baskets, seed):
    """Arrival-pattern property: singles, concurrent bursts, duplicate
    baskets and mixed top_k all yield responses bit-identical to the batch
    engine for the answering generation."""
    rb0, _ = rulebooks
    rng = np.random.default_rng(seed)
    plan = []                           # (basket index, top_k)
    for _ in range(rng.integers(3, 6)):
        burst = int(rng.integers(1, 24))
        k = int(rng.choice([3, 7]))
        idx = rng.integers(0, len(baskets), burst)
        plan += [(int(i), k) for i in idx]   # duplicates arise naturally

    with Gateway(rb0, max_batch=16, max_wait_ms=1.0, cache_capacity=256) as gw:
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = list(pool.map(lambda p: (p, gw.submit(baskets[p[0]], top_k=p[1])), plan))
        for (i, k), fut in futs:
            resp = fut.result(timeout=60)
            assert resp.generation == 0
            check_response(resp, rb0, baskets[i], k)


def test_packed_row_submission_equals_id_list(rulebooks, baskets):
    from repro_torch.serving import pack_baskets

    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=4, max_wait_ms=0.0, cache_capacity=0) as gw:
        packed = pack_baskets([baskets[0]], NUM_ITEMS)[0]
        a = gw.query(packed, top_k=5)
        b = gw.query(baskets[0], top_k=5)
        assert np.array_equal(a.items, b.items) and np.array_equal(a.scores, b.scores)


def test_top_k_clamps_to_vocabulary(rulebooks, baskets):
    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=4, max_wait_ms=0.0) as gw:
        resp = gw.query(baskets[0], top_k=10_000)
        assert resp.items.shape == (NUM_ITEMS,)
        check_response(resp, rb0, baskets[0], 10_000)


# ---------------------------------------------------------------- hot-swap --
def test_hot_swap_zero_dropped_zero_mixed(rulebooks, baskets):
    """Concurrent load across a swap: every admitted request resolves, every
    response verifies bit-identically against the generation it names, and
    requests submitted after the swap returns are answered by the new
    generation only."""
    rb0, rb1 = rulebooks
    rbs = {0: rb0, 1: rb1}
    with Gateway(rb0, max_batch=8, max_wait_ms=0.5, queue_depth=4096,
                 cache_capacity=0) as gw:
        pre = [gw.submit(baskets[i % len(baskets)], top_k=5) for i in range(40)]
        for f in pre:                      # guarantee gen-0 traffic completed
            assert f.result(60).generation == 0

        with ThreadPoolExecutor(max_workers=8) as pool:
            mid = list(pool.map(
                lambda i: (i, gw.submit(baskets[i % len(baskets)], top_k=5)),
                range(120)))
            new_gen = gw.hot_swap(rb1)     # swap while the pool is firing
            assert new_gen == 1
        post = [(i, gw.submit(baskets[i % len(baskets)], top_k=5)) for i in range(20)]

        responses = [(i, f.result(timeout=60)) for i, f in mid + post]
        assert len(responses) == 140       # zero dropped
        for i, resp in responses:
            assert resp.generation in (0, 1)
            check_response(resp, rbs[resp.generation], baskets[i % len(baskets)], 5)
        for _, resp in responses[-20:]:    # after hot_swap returned: new gen only
            assert resp.generation == 1
        assert gw.generation == 1
        assert gw.stats()["swaps"] == 1


def test_hot_swap_rejects_vocabulary_change(rulebooks):
    import dataclasses

    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=4, max_wait_ms=0.0) as gw:
        widened = dataclasses.replace(rb0, num_items=NUM_ITEMS * 2)
        with pytest.raises(ValueError, match="vocabulary"):
            gw.hot_swap(widened)


# ------------------------------------------------------------ backpressure --
def test_batcher_backpressure_rejects_are_reported():
    metrics = GatewayMetrics()
    done = []

    def slow_dispatch(group):
        time.sleep(0.05)
        for r in group:
            done.append(r)
            r.future.set_result(r.top_k)

    batcher = MicroBatcher(slow_dispatch, max_batch=2, max_wait_ms=0.0,
                           queue_depth=4, metrics=metrics)
    accepted, rejected = [], 0
    for i in range(30):
        req = Request(packed=np.zeros(1, np.uint32), top_k=i, future=Future(),
                      t_submit=time.perf_counter())
        try:
            batcher.submit(req)
            accepted.append(req)
        except AdmissionRejected as e:
            assert e.reason == "admission queue full"
            rejected += 1
    batcher.close()

    assert rejected > 0                        # overload actually rejected
    assert len(accepted) + rejected == 30      # every request accounted for
    assert metrics.submitted == len(accepted) and metrics.rejected == rejected
    for req in accepted:                       # admitted -> answered, no drops
        assert req.future.result(timeout=10) == req.top_k
    assert len(done) == len(accepted)


def test_gateway_backpressure_counts_are_consistent(rulebooks, baskets):
    rb0, _ = rulebooks
    gw = Gateway(rb0, max_batch=4, max_wait_ms=0.0, queue_depth=2, cache_capacity=0)
    real_match = gw._match
    gw._match = lambda *a, **kw: (time.sleep(0.03), real_match(*a, **kw))[1]
    futs, rejected = [], 0
    for i in range(60):
        try:
            futs.append(gw.submit(baskets[i % len(baskets)], top_k=5))
        except AdmissionRejected:
            rejected += 1
    responses = [f.result(timeout=60) for f in futs]
    gw.close()
    assert rejected > 0 and len(responses) + rejected == 60
    s = gw.stats()
    assert s["submitted"] == len(responses) and s["rejected"] == rejected
    assert s["completed"] == len(responses) and s["failed"] == 0
    # rejected probes are not misses, and the cache's own counters agree
    # with the gateway metrics even under rejection-heavy load
    assert s["cache_hits"] + s["cache_misses"] == s["submitted"]
    assert s["cache"]["hits"] == s["cache_hits"]
    assert s["cache"]["misses"] == s["cache_misses"]


def test_dispatch_failure_reaches_futures_never_drops():
    metrics = GatewayMetrics()

    def broken_dispatch(group):
        raise ValueError("kernel exploded")

    batcher = MicroBatcher(broken_dispatch, max_batch=4, max_wait_ms=0.0,
                           queue_depth=8, metrics=metrics)
    req = Request(packed=np.zeros(1, np.uint32), top_k=1, future=Future(),
                  t_submit=time.perf_counter())
    batcher.submit(req)
    with pytest.raises(ValueError, match="kernel exploded"):
        req.future.result(timeout=10)
    batcher.close()
    assert metrics.failed == 1


def test_submit_after_close_rejected(rulebooks, baskets):
    rb0, _ = rulebooks
    gw = Gateway(rb0, max_batch=4, max_wait_ms=0.0)
    gw.close()
    with pytest.raises(AdmissionRejected, match="closed"):
        gw.submit(baskets[0])


# ----------------------------------------------------------------- caching --
def test_cache_hit_is_bit_identical_and_generation_scoped(rulebooks, baskets):
    rb0, rb1 = rulebooks
    with Gateway(rb0, max_batch=4, max_wait_ms=0.0, cache_capacity=64) as gw:
        miss = gw.query(baskets[0], top_k=5)
        hit = gw.query(baskets[0], top_k=5)
        assert not miss.cached and hit.cached
        assert np.array_equal(miss.items, hit.items)
        assert np.array_equal(miss.scores, hit.scores)
        assert gw.cache.hits == 1

        other_k = gw.query(baskets[0], top_k=3)          # top_k is in the key
        assert not other_k.cached

        gw.hot_swap(rb1)
        fresh = gw.query(baskets[0], top_k=5)            # generation is in the key
        assert not fresh.cached and fresh.generation == 1
        check_response(fresh, rb1, baskets[0], 5)
        assert gw.cache.hit_rate == gw.metrics.cache_hit_rate
        evicted = gw.cache.evict_generation(0)
        assert evicted > 0


def test_basket_cache_lru_eviction_and_accounting():
    cache = BasketCache(capacity=2)
    k = lambda i: basket_key(np.full(2, i, np.uint32), 5, 0)
    e = lambda i: (np.array([i]), np.array([float(i)]), 0, 1)
    cache.put(k(0), e(0))
    cache.put(k(1), e(1))
    assert cache.get(k(0)) is not None       # refresh 0 -> 1 becomes LRU
    cache.put(k(2), e(2))                    # evicts 1
    assert cache.get(k(1)) is None
    assert cache.get(k(2)) is not None
    snap = cache.snapshot()
    assert snap["size"] == 2 and snap["evictions"] == 1
    assert snap["hits"] == 2 and snap["misses"] == 1
    disabled = BasketCache(capacity=0)
    disabled.put(k(0), e(0))
    assert disabled.get(k(0)) is None and len(disabled) == 0


# ----------------------------------------------------------------- metrics --
def test_latency_histogram_quantiles_conservative():
    h = LatencyHistogram()
    assert h.quantile(0.5) == 0.0
    rng = np.random.default_rng(0)
    samples = rng.uniform(1e-3, 100e-3, 2000)
    for s in samples:
        h.record(float(s))
    for q in (0.5, 0.95, 0.99):
        true = float(np.quantile(samples, q))
        est = h.quantile(q)
        assert est >= true * 0.999           # never an underestimate
        assert est <= true * 1.25 * 1.05     # within one bucket's growth
    snap = h.snapshot()
    assert snap["count"] == 2000
    assert snap["min_ms"] == pytest.approx(samples.min() * 1e3)
    assert snap["max_ms"] == pytest.approx(samples.max() * 1e3)
    assert h.quantile(1.0) <= samples.max() * 1.0001


def test_gateway_metrics_occupancy_and_snapshot():
    m = GatewayMetrics()
    m.record_batch(3, 4)
    m.record_batch(1, 4)
    assert m.batch_occupancy == pytest.approx(0.5)
    m.record_cache(True)
    m.record_cache(False)
    assert m.cache_hit_rate == pytest.approx(0.5)
    m.record_admission(True)
    m.record_response(0.010)
    snap = m.snapshot()
    assert snap["batches"] == 2 and snap["submitted"] == 1
    assert snap["latency"]["count"] == 1
    assert snap["latency"]["p50_ms"] >= 10.0


def test_occupancy_counts_real_vs_padded(rulebooks, baskets):
    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=8, max_wait_ms=0.0, cache_capacity=0) as gw:
        for b in baskets[:5]:
            gw.query(b, top_k=5)
        s = gw.stats()
        assert s["batch_rows_real"] == 5
        assert s["batch_rows_padded"] >= 5
        assert 0.0 < s["batch_occupancy"] <= 1.0
        assert s["latency"]["count"] == 5


# ------------------------------------------------------------------ bucket --
def test_pow2_bucket_ladder():
    assert [pow2_bucket(n, 64) for n in (1, 2, 3, 5, 8, 9, 33, 64)] == \
        [1, 2, 4, 8, 8, 16, 64, 64]
    assert pow2_bucket(33, 48) == 48         # non-pow2 max_batch clamps
    assert pow2_bucket(3, 64, multiple=3) == 6
    assert pow2_bucket(1, 64, multiple=4) == 4
    with pytest.raises(ValueError):
        pow2_bucket(0, 64)
    with pytest.raises(ValueError):
        pow2_bucket(65, 64)


# --------------------------------------------------------------- deadlines --
def test_batcher_drops_expired_requests_at_dispatch():
    """A request whose deadline passed while queued is failed with
    DeadlineExceeded at dispatch time — the device never works for a caller
    that has given up — while live requests in the same batch are served."""
    from repro_torch.serving import DeadlineExceeded

    metrics = GatewayMetrics()
    served = []

    def dispatch(group):
        for r in group:
            served.append(r.top_k)
            r.future.set_result(r.top_k)

    batcher = MicroBatcher(dispatch, max_batch=8, max_wait_ms=0.0,
                           queue_depth=16, metrics=metrics)
    now = time.perf_counter()
    expired = Request(packed=np.zeros(1, np.uint32), top_k=1, future=Future(),
                      t_submit=now, deadline=now - 0.001)      # already past
    live = Request(packed=np.zeros(1, np.uint32), top_k=2, future=Future(),
                   t_submit=now, deadline=now + 30.0)
    batcher.submit(expired)
    batcher.submit(live)
    assert live.future.result(timeout=10) == 2
    with pytest.raises(DeadlineExceeded):
        expired.future.result(timeout=10)
    batcher.close()
    assert served == [2]                       # expired never dispatched
    assert metrics.deadline_expired == 1
    assert metrics.failed == 1
    assert metrics.snapshot()["deadline_expired"] == 1


def test_gateway_deadline_ms_bounds_the_request(rulebooks, baskets):
    """deadline_ms=0 expires in the queue (typed failure, counted);
    a generous deadline serves normally and stays bit-identical."""
    from repro_torch.serving import DeadlineExceeded

    rb0, _ = rulebooks
    with Gateway(rb0, max_wait_ms=0.0, warmup=False, cache_capacity=0) as gw:
        gw.query(baskets[0])                   # warm off the clock
        ok = gw.query(baskets[1], deadline_ms=30_000)
        check_response(ok, rb0, baskets[1], gw.default_top_k)
        with pytest.raises(DeadlineExceeded):
            gw.query(baskets[2], deadline_ms=0)
        s = gw.stats()
        assert s["deadline_expired"] == 1
        # deadline expiry is an explicit failure, never a silent drop
        assert s["completed"] == 2 and s["failed"] == 1


# ------------------------------------------------ generation age (§14) -----
def test_generation_age_gauge_resets_on_hot_swap(rulebooks):
    """``generation_age_seconds`` is a LIVE gauge: it grows between reads
    without anyone writing it, and a hot-swap commit re-stamps it — the
    signal the freshness SLO watches."""
    rb0, rb1 = rulebooks
    with Gateway(rb0, max_batch=4, max_wait_ms=0.0, cache_capacity=0) as gw:
        a1 = gw.metrics.generation_age.value
        time.sleep(0.05)
        a2 = gw.metrics.generation_age.value
        assert a2 > a1 >= 0.0                  # ages with no writer
        assert gw.stats()["generation_age_s"] >= a2
        pre_swap = gw.metrics.generation_age.value
        gw.hot_swap(rb1)
        assert gw.metrics.generation_age.value < pre_swap   # re-stamped
        # and it reaches the registry cut the SLO evaluator differences
        cut = gw.metrics.registry.raw_snapshot()
        assert 0.0 <= cut["gateway_generation_age_seconds"] < pre_swap


# ------------------------------------------------- the port's own contract --
def test_gateway_needs_cuda_or_explicit_cpu(rulebooks):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    rb0, _ = rulebooks
    with pytest.raises(RuntimeError, match="CUDA"):
        _Gateway(rb0)
    from repro_torch.serving import Router

    with pytest.raises(RuntimeError, match="CUDA"):
        Router(rb0, 2)


def test_place_once_and_placed_rulebook_reused(rulebooks, baskets):
    """A host rulebook is placed on the gateway's device; an already placed
    one is served as it is; either answers like the direct engine."""
    from repro_torch.serving import place_rulebook

    rb0, rb1 = rulebooks
    placed = place_rulebook(rb1, "cpu")
    with Gateway(rb0, max_batch=8, max_wait_ms=0.0, cache_capacity=0) as gw:
        assert gw._generation.rulebook.device.type == "cpu"
        gen = gw.prepare_swap(placed)
        assert gen.rulebook is placed          # not copied again
        assert gw.commit_swap(gen) == 1
        check_response(gw.query(baskets[3], top_k=5), rb1, baskets[3], 5)


@pytest.mark.parametrize("burst", [1, 2, 3, 8, 13, 16])
def test_each_bucket_bit_identical(rulebooks, baskets, burst):
    """A burst held in the queue until it is whole dispatches as one batch
    at its bucket; every response equals recommend at that bucket."""
    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=16, max_wait_ms=0.0, cache_capacity=0, warmup="ladder") as gw:
        entered, gate = threading.Event(), threading.Event()
        real_match = gw._match
        gw._match = lambda *a, **kw: (entered.set(), gate.wait(10), real_match(*a, **kw))[2]
        first = gw.submit(baskets[0], top_k=5)      # holds the worker
        assert entered.wait(10)
        futs = [gw.submit(baskets[1 + i], top_k=5) for i in range(burst)]
        gate.set()
        assert first.result(60).bucket == 1
        resps = [f.result(60) for f in futs]
        assert {r.bucket for r in resps} == {pow2_bucket(burst, 16)}
        for i, r in enumerate(resps):
            check_response(r, rb0, baskets[1 + i], 5)


def test_swap_prepared_on_another_thread(rulebooks, baskets):
    """prepare_swap from a second thread while traffic runs, commit from
    a third: every response verifies against the generation it names."""
    rb0, rb1 = rulebooks
    rbs = {0: rb0, 1: rb1}
    with Gateway(rb0, max_batch=8, max_wait_ms=0.5, queue_depth=4096, cache_capacity=0) as gw:
        box = {}
        preparer = threading.Thread(target=lambda: box.update(gen=gw.prepare_swap(rb1)))
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = list(pool.map(lambda i: (i, gw.submit(baskets[i % 64], top_k=4)), range(60)))
            preparer.start()
            preparer.join(30)
            committer = threading.Thread(target=lambda: gw.commit_swap(box["gen"]))
            committer.start()
            committer.join(30)
            futs += list(pool.map(lambda i: (i, gw.submit(baskets[i % 64], top_k=4)), range(60, 100)))
        gens = set()
        for i, f in futs:
            r = f.result(60)
            gens.add(r.generation)
            check_response(r, rbs[r.generation], baskets[i % 64], 4)
        assert gens <= {0, 1} and 1 in gens and gw.generation == 1


def _assert_close_to_jax(got_items, got_scores, want_items, want_scores):
    np.testing.assert_allclose(got_scores, want_scores, rtol=RTOL, atol=ATOL)
    s = np.asarray(want_scores)[None]
    close = np.zeros_like(s, dtype=bool)
    gaps = np.abs(np.diff(s, axis=1)) <= ATOL + RTOL * np.abs(s[:, 1:])
    close[:, 1:] |= gaps
    close[:, :-1] |= gaps
    np.testing.assert_array_equal(np.asarray(got_items)[None][~close],
                                  np.asarray(want_items)[None][~close])


@pytest.mark.parametrize("max_batch", [1, 8, 64])
def test_matches_jax_gateway_on_carried_rulebook(small_db, baskets, max_batch):
    """The JAX package's rulebook, carried across as numpy arrays, served by
    both gateways: the same items and scores within tolerance."""
    from repro.core.apriori import AprioriConfig as JConfig
    from repro.core.apriori import mine as jmine
    from repro.serving import Gateway as JGateway
    from repro.serving import compile_rulebook as jcompile
    from repro_torch.serving.rulebook import rulebook_from_arrays

    jbook = jcompile(jmine(small_db, JConfig(min_support=0.05, max_k=3, count_impl="jnp")),
                     min_confidence=0.3, num_items=NUM_ITEMS)
    tbook = rulebook_from_arrays(jbook.ante_packed, jbook.cons_packed, jbook.ante_len,
                                 jbook.scores, jbook.num_items, jbook.score_kind)
    kw = dict(max_batch=max_batch, max_wait_ms=0.5, cache_capacity=0)
    with JGateway(jbook, impl="jnp", **kw) as jgw, Gateway(tbook, **kw) as tgw:
        with ThreadPoolExecutor(max_workers=8) as pool:
            jf = [jgw.submit(b, top_k=6) for b in baskets]
            tf = list(pool.map(lambda b: tgw.submit(b, top_k=6), baskets))
        for b, j, t in zip(baskets, jf, tf):
            jr, tr = j.result(60), t.result(60)
            check_response(tr, tbook, b, 6)
            _assert_close_to_jax(tr.items, tr.scores, jr.items, jr.scores)


def test_stats_keys_match_jax_gateway(rulebooks, small_db):
    from repro.core.apriori import AprioriConfig as JConfig
    from repro.core.apriori import mine as jmine
    from repro.serving import Gateway as JGateway
    from repro.serving import compile_rulebook as jcompile

    jbook = jcompile(jmine(small_db, JConfig(min_support=0.05, max_k=3, count_impl="jnp")),
                     min_confidence=0.3, num_items=NUM_ITEMS)
    with JGateway(jbook, impl="jnp", max_batch=4) as jgw, Gateway(rulebooks[0], max_batch=4) as tgw:
        js, ts = jgw.stats(), tgw.stats()
        assert sorted(ts) == sorted(js)
        assert sorted(ts["cache"]) == sorted(js["cache"])
        assert sorted(tgw.metrics.registry.snapshot()) == sorted(jgw.metrics.registry.snapshot())


# ------------------------------------------------------------ cycle trace --
CYCLE = ("cycle.collect", "cycle.assemble", "cycle.h2d", "cycle.match", "cycle.topk", "cycle.d2h",
         "cycle.demux")


def test_traced_batches_get_one_cycle_span_each(rulebooks, baskets):
    """Every batch holding a sampled request gets exactly one
    ``gateway.batch`` span, under a sampled request's span; its ``cycle.*``
    stages and ``gpu.*`` spans nest inside it, and the stages tile it in
    order, each starting where the one before ended.  The per-request
    spans are as before."""
    from repro_torch.obs import Tracer

    rb0, _ = rulebooks
    tracer = Tracer(sample_rate=1.0)
    with Gateway(rb0, max_batch=8, max_wait_ms=2.0, cache_capacity=0, tracer=tracer) as gw:
        with ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(lambda b: gw.submit(b), baskets * 2))
        for f, b in zip(futs, baskets * 2):
            check_response(f.result(timeout=30), rb0, b, gw.default_top_k)
        batches = gw.metrics.snapshot()["batches"]
    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    cycles = [s for s in spans if s.name == "gateway.batch"]
    assert len(cycles) == batches > 1
    assert sum(c.attrs["batch"] for c in cycles) == len(baskets) * 2
    for c in cycles:
        assert by_id[c.parent_id].name == "gateway.request"
        kids = sorted((s for s in spans if s.parent_id == c.span_id), key=lambda s: s.t0)
        assert sorted(s.name for s in kids) == sorted(CYCLE + ("gpu.match", "gpu.topk"))
        for s in kids:
            assert c.t0 <= s.t0 <= s.t1 <= c.t1, s.name
        stages = [s for s in kids if s.name.startswith("cycle.")]
        assert [s.name for s in stages] == list(CYCLE)
        for a, z in zip(stages, stages[1:]):
            assert a.t1 == z.t0   # they tile the cycle
        assert stages[0].t0 == c.t0 and stages[-1].t1 == c.t1
    per_request = {s.name for s in spans if s.parent_id is not None and by_id[s.parent_id].name == "gateway.request"}
    assert {"cache.probe", "queue.wait", "batch.assemble", "device.dispatch"} <= per_request
    assert all(set(s.attrs) == {"top_k", "outcome", "generation", "bucket"}
               for s in spans if s.name == "gateway.request")


def test_unsampled_batches_and_no_tracer_record_no_cycle(rulebooks, baskets, monkeypatch):
    """A batch with no sampled request, or a gateway with no tracer, never
    builds a cycle trace and hands ``match_batch`` no stage hook."""
    from repro_torch.obs import Tracer
    from repro_torch.serving import gateway as gmod

    rb0, _ = rulebooks
    laps = []
    real = gmod.match_batch
    monkeypatch.setattr(gmod, "match_batch", lambda *a, **kw: (laps.append(kw.get("lap")), real(*a, **kw))[1])
    tracer = Tracer(sample_rate=0.0)
    for tr in (None, tracer):
        with Gateway(rb0, max_batch=8, max_wait_ms=0.0, cache_capacity=0, tracer=tr, warmup=False) as gw:
            monkeypatch.setattr(gmod, "_CycleTrace", None)   # building one would raise
            for f, b in [(gw.submit(b), b) for b in baskets[:16]]:
                check_response(f.result(timeout=30), rb0, b, gw.default_top_k)
    assert laps and all(lap is None for lap in laps)
    assert tracer.spans() == []


def test_cycle_stages_are_profiler_ranges_of_the_dispatch_thread(rulebooks, baskets, tmp_path):
    """A profiler that records every thread (``profile_all_threads``)
    carries the live ``cycle.*`` stages of the gateway's dispatch thread,
    started before it, as ranges of their names; the back-dated
    ``cycle.collect`` is not one."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer

    rb0, _ = rulebooks
    with Gateway(rb0, max_batch=8, max_wait_ms=2.0, cache_capacity=0, tracer=Tracer(sample_rate=1.0)) as gw:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            for f, b in [(gw.submit(b), b) for b in baskets[:16]]:
                check_response(f.result(timeout=30), rb0, b, gw.default_top_k)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    events = json.loads((tmp_path / "prof.json").read_text())["traceEvents"]
    marks = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(CYCLE[1:]) <= marks and "cycle.collect" not in marks
