"""PyTorch port: supervised serving on the CPU.

Mirrors ``tests/test_supervisor.py``: a dead gateway dispatch worker is
restarted, ONLY the in-flight batch's futures fail (with WorkerCrashed),
queued requests survive the restart, and the restart is counted.  Workers
die through the batcher's crash hook, never by timing."""

import time
from concurrent.futures import Future

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro_torch.distributed.supervisor import WorkerSupervisor  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    GatewayMetrics,
    MicroBatcher,
    Request,
    WorkerCrashed,
)

# killing the dispatch worker IS the subject under test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _req(top_k=5):
    return Request(packed=np.zeros(1, np.uint32), top_k=top_k, future=Future(),
                   t_submit=time.perf_counter())


def _wait_until(pred, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


class _FakeGateway:
    """WorkerSupervisor only touches ``gateway._batcher``."""

    def __init__(self, batcher):
        self._batcher = batcher


def _echo_dispatch(group):
    for r in group:
        r.future.set_result(r.top_k)


# -------------------------------------------------------- restart_worker --
def test_restart_fails_only_inflight_futures():
    """Kill the worker while a batch is in flight: that batch's futures get
    WorkerCrashed, requests admitted AFTER the crash drain through the fresh
    worker, and the restart lands in the metric."""
    metrics = GatewayMetrics()
    batcher = MicroBatcher(_echo_dispatch, max_batch=4, max_wait_ms=0.0,
                           queue_depth=64, metrics=metrics)
    crash_once = {"armed": True}

    def hook(batch):
        if crash_once["armed"]:
            crash_once["armed"] = False
            batcher._crash_hook = None
            raise SystemExit("injected dispatch-worker death")

    batcher._crash_hook = hook
    doomed = _req(top_k=1)
    batcher.submit(doomed)
    assert _wait_until(lambda: not batcher.worker_alive)

    assert batcher.restart_worker() is True
    with pytest.raises(WorkerCrashed):
        doomed.future.result(timeout=10)
    assert batcher.worker_alive

    served = _req(top_k=7)                 # the fresh worker really dispatches
    batcher.submit(served)
    assert served.future.result(timeout=10) == 7
    batcher.close()
    assert metrics.worker_restarts == 1
    assert metrics.failed == 1             # exactly the in-flight request
    assert "worker_restarts" in metrics.snapshot()


def test_queued_requests_survive_restart():
    """Requests sitting in the admission queue at crash time are NOT failed:
    they are served by the restarted worker (admitted => resolved)."""
    gate = {"evt": None}

    def slow_dispatch(group):
        if gate["evt"] is not None:
            gate["evt"].wait(timeout=10)
        _echo_dispatch(group)

    import threading

    gate["evt"] = threading.Event()
    batcher = MicroBatcher(slow_dispatch, max_batch=1, max_wait_ms=0.0,
                           queue_depth=64, metrics=GatewayMetrics())
    armed = {"on": True}

    def hook(batch):
        if armed["on"]:
            armed["on"] = False
            raise SystemExit("boom")

    inflight = _req(top_k=1)
    queued = [_req(top_k=10 + i) for i in range(5)]
    batcher._crash_hook = hook
    batcher.submit(inflight)               # max_batch=1: alone in its batch
    for r in queued:
        batcher.submit(r)
    assert _wait_until(lambda: not batcher.worker_alive)
    gate["evt"].set()
    assert batcher.restart_worker() is True

    with pytest.raises(WorkerCrashed):
        inflight.future.result(timeout=10)
    for i, r in enumerate(queued):         # every queued request answered
        assert r.future.result(timeout=10) == 10 + i
    batcher.close()


def test_restart_noop_when_alive_or_closed():
    batcher = MicroBatcher(_echo_dispatch, max_batch=4, max_wait_ms=0.0)
    assert batcher.restart_worker() is False      # alive: nothing to do
    batcher.close()
    assert batcher.restart_worker() is False      # closed: shutdown != crash


def test_close_with_dead_worker_fails_stranded_not_hangs():
    """An UNsupervised batcher whose worker died must still close promptly,
    failing the stranded futures instead of joining a dead thread forever."""
    batcher = MicroBatcher(_echo_dispatch, max_batch=4, max_wait_ms=0.0,
                           metrics=GatewayMetrics())
    batcher._crash_hook = lambda batch: (_ for _ in ()).throw(SystemExit("boom"))
    doomed = _req()
    batcher.submit(doomed)
    assert _wait_until(lambda: not batcher.worker_alive)
    t0 = time.perf_counter()
    batcher.close()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(WorkerCrashed):
        doomed.future.result(timeout=10)


# ----------------------------------------------------------- supervisor --
def test_supervisor_restarts_dead_worker():
    metrics = GatewayMetrics()
    batcher = MicroBatcher(_echo_dispatch, max_batch=4, max_wait_ms=0.0,
                           queue_depth=64, metrics=metrics)
    armed = {"on": True}

    def hook(batch):
        if armed["on"]:
            armed["on"] = False
            raise SystemExit("injected death")

    batcher._crash_hook = hook
    with WorkerSupervisor(_FakeGateway(batcher), poll_interval_s=0.005) as sup:
        doomed = _req(top_k=3)
        batcher.submit(doomed)
        with pytest.raises(WorkerCrashed):
            doomed.future.result(timeout=10)   # supervisor repaired the hang
        assert _wait_until(lambda: batcher.worker_alive)
        ok = _req(top_k=9)
        batcher.submit(ok)
        assert ok.future.result(timeout=10) == 9
        assert _wait_until(lambda: sup.restarts == 1)
    batcher.close()
    assert metrics.worker_restarts == 1


def test_supervisor_treats_shutdown_as_not_a_crash():
    """After close(), the worker thread exits — the supervisor must NOT
    count that as a death or try to restart it."""
    batcher = MicroBatcher(_echo_dispatch, max_batch=4, max_wait_ms=0.0,
                           metrics=GatewayMetrics())
    with WorkerSupervisor(_FakeGateway(batcher), poll_interval_s=0.005) as sup:
        r = _req()
        batcher.submit(r)
        assert r.future.result(timeout=10) == r.top_k
        batcher.close()
        time.sleep(0.05)                   # give the poll loop a few beats
        assert sup.restarts == 0
    assert not batcher.worker_alive


# -------------------------------------------------------- restart storm --
def test_restart_guard_window_backoff_and_give_up():
    from repro_torch.distributed.supervisor import RestartGuard

    g = RestartGuard(max_restarts=3, window_s=10.0, backoff_s=0.5,
                     backoff_multiplier=2.0)
    assert g.allow(100.0)
    g.record(100.0)
    assert not g.allow(100.1)            # inside the 0.5 s backoff
    assert g.allow(100.6)
    g.record(100.6)
    assert not g.allow(101.0)            # backoff doubled to 1.0 s
    assert g.allow(101.7)
    g.record(101.7)
    assert not g.allow(105.0)            # window holds 3 == max: storm
    assert g.gave_up
    assert not g.allow(1000.0)           # permanent: no resurrection
    with pytest.raises(ValueError):
        RestartGuard(max_restarts=0)


def test_restart_guard_window_slides():
    from repro_torch.distributed.supervisor import RestartGuard

    g = RestartGuard(max_restarts=2, window_s=1.0, backoff_s=0.0)
    g.record(100.0)
    g.record(100.1)
    assert g.allow(101.5)                # both restarts aged out: budget back
    assert not g.gave_up


def test_supervisor_declares_always_crashing_worker_dead():
    """A worker that crashes on EVERY dispatch must not be restarted
    forever: after max_restarts within the window the supervisor declares it
    dead, closes the batcher (pending futures fail explicitly, new submits
    are refused), and surfaces the verdict in stats()."""
    metrics = GatewayMetrics()
    batcher = MicroBatcher(_echo_dispatch, max_batch=1, max_wait_ms=0.0,
                           queue_depth=64, metrics=metrics)
    batcher._crash_hook = lambda batch: (_ for _ in ()).throw(
        SystemExit("poisoned: crashes on every dispatch"))
    requests = [_req(top_k=i) for i in range(8)]   # max_batch=1: each wave
    for r in requests:                             # re-feeds the fresh worker
        batcher.submit(r)

    with WorkerSupervisor(_FakeGateway(batcher), poll_interval_s=0.005,
                          max_restarts=3, restart_window_s=30.0,
                          restart_backoff_s=0.005) as sup:
        assert _wait_until(lambda: sup.dead, timeout=30.0)
        assert sup.restarts == 3                   # budget spent, then dead
        s = sup.stats()
        assert s["dead"] is True and s["restarts"] == 3
        # every pending future failed explicitly — no hangs, no silent drops
        for r in requests:
            with pytest.raises(WorkerCrashed):
                r.future.result(timeout=10)
        # the dead replica sheds load instead of hanging it
        from repro_torch.serving import AdmissionRejected
        with pytest.raises(AdmissionRejected):
            batcher.submit(_req())
        assert batcher.closed


def test_replica_set_supervisor_restarts_and_gives_up_per_replica():
    """One poll loop over N batchers: the crashed-once replica is revived,
    the always-crashing one burns its budget and is declared dead — with the
    owner notified through the callbacks."""
    import threading

    good_metrics, bad_metrics = GatewayMetrics(), GatewayMetrics()
    good = MicroBatcher(_echo_dispatch, max_batch=1, max_wait_ms=0.0,
                        queue_depth=64, metrics=good_metrics)
    bad = MicroBatcher(_echo_dispatch, max_batch=1, max_wait_ms=0.0,
                       queue_depth=64, metrics=bad_metrics)
    once = {"armed": True}

    def crash_once(batch):
        if once["armed"]:
            once["armed"] = False
            raise SystemExit("transient")

    good._crash_hook = crash_once
    bad._crash_hook = lambda batch: (_ for _ in ()).throw(SystemExit("poisoned"))

    restarted, gave_up = [], []
    from repro_torch.distributed import ReplicaSetSupervisor

    with ReplicaSetSupervisor(
        [_FakeGateway(good), _FakeGateway(bad)], poll_interval_s=0.005,
        max_restarts=2, restart_window_s=30.0, restart_backoff_s=0.005,
        on_restarted=restarted.append, on_gave_up=gave_up.append,
    ) as sup:
        doomed = _req(top_k=1)
        good.submit(doomed)                    # crashes once, then revived
        for i in range(6):
            bad.submit(_req(top_k=i))          # keeps crashing until dead
        with pytest.raises(WorkerCrashed):
            doomed.future.result(timeout=10)
        ok = _req(top_k=9)
        _wait_until(lambda: good.worker_alive)
        good.submit(ok)
        assert ok.future.result(timeout=10) == 9   # replica 0 fully revived
        assert _wait_until(lambda: sup.dead == [False, True], timeout=30.0)
        s = sup.stats()
        assert s["dead"] == [False, True]
        assert s["restarts"][1] == 2
        assert 0 in restarted and gave_up == [1]
    good.close()
    assert bad.closed                          # closed by the give-up path


# ------------------------------------------ a real gateway of the port --
def test_supervised_gateway_crash_then_bit_identical_answers(small_db):
    """The port's gateway under a WorkerSupervisor: the crash hook kills its
    dispatch worker once; the in-flight request fails typed, the supervisor
    restarts the worker, and every later answer is the port's recommend."""
    import threading

    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.serving import Gateway, compile_rulebook, recommend

    rb = compile_rulebook(
        mine(small_db, AprioriConfig(min_support=0.05, max_k=3, representation="packed"),
             device="cpu"),
        min_confidence=0.3, num_items=32,
    )
    baskets = [np.flatnonzero(row).tolist() for row in small_db[:24]]
    with Gateway(rb, device="cpu", max_batch=4, max_wait_ms=0.0, cache_capacity=0) as gw:
        sup = WorkerSupervisor(gw, poll_interval_s=0.005)
        try:
            fired = threading.Event()

            def hook(batch):
                gw._batcher._crash_hook = None
                fired.set()
                raise SystemExit("injected dispatch-worker death")

            gw._batcher._crash_hook = hook
            doomed = gw.submit(baskets[0], top_k=5)
            with pytest.raises(WorkerCrashed):
                doomed.result(timeout=10)
            assert fired.is_set()
            assert _wait_until(lambda: sup.restarts == 1)
            for b in baskets[1:]:
                resp = gw.query(b, top_k=5, timeout=10)
                direct = recommend(rb, [b], top_k=5, batch_size=resp.bucket, device="cpu")
                assert np.array_equal(resp.items, direct.items[0])
                assert np.array_equal(resp.scores, direct.scores[0])
            assert gw.stats()["worker_restarts"] == 1
        finally:
            sup.close()
