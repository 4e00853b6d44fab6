"""The open-loop driver against a fake gateway that stalls once: latency is
taken from each request's due time, so the stall shows in the requests that
waited behind it; rejected and failed requests count as slower than any
answer; and the generator's lateness is reported."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from bench import common
from bench.drivers import open_loop


class Answer:
    items = np.arange(10, dtype=np.int32)
    scores = np.zeros(10, dtype=np.float32)


class FakeGateway:
    """Answers every request at once, except: ``submit`` of request
    ``stall_at`` blocks for ``stall_s``; request ``reject_at`` is refused;
    request ``fail_at``'s answer is an exception."""

    def __init__(self, stall_at, stall_s, reject_at, fail_at):
        self.n = 0
        self.stall_at, self.stall_s, self.reject_at, self.fail_at = stall_at, stall_s, reject_at, fail_at
        self.lock = threading.Lock()

        class Metrics:
            def snapshot(_self):
                return dict(batches=self.n, batch_rows_real=self.n, batch_rows_padded=self.n, cache_hits=0,
                            completed=self.n)

        self.metrics = Metrics()

    def submit(self, basket):
        from repro_torch.serving.batcher import AdmissionRejected

        with self.lock:
            i = self.n
            self.n += 1
        if i == self.stall_at:
            time.sleep(self.stall_s)
        if i == self.reject_at:
            raise AdmissionRejected("admission queue full")
        fut = Future()
        if i == self.fail_at:
            fut.set_exception(RuntimeError("the batch failed"))
        else:
            fut.set_result(Answer)
        return fut


def test_a_stall_shows_in_later_requests_and_failures_count_as_slowest():
    n, gap, stall = 400, 0.002, 0.2
    due = np.arange(n) * gap
    gw = FakeGateway(stall_at=50, stall_s=stall, reject_at=300, fail_at=301)
    run = open_loop.run_schedule(gw, due, np.zeros((n, 2), np.uint32), seconds=n * gap, drain_s=1.0)
    st, out = run["stats"], run["outcome"]
    lat = out["latency"]
    # the stalled submit blocks the one load thread: requests due during it
    # go out late, and their latency counts that wait from the due time
    behind = np.arange(51, 51 + int(0.5 * stall / gap))
    assert (lat[behind] >= 0.5 * stall - 0.02).all()
    assert lat[51] >= stall - 0.03
    assert np.median(lat[200:300]) < 0.02   # caught up afterwards
    assert st["late_max_ms"] >= 1e3 * stall - 30
    assert st["late_p50_ms"] < st["late_max_ms"]
    # refused and failed: counted, and slower than every answer
    assert st["rejected"] == 1 and st["failed"] == 2 and st["unanswered"] == 0
    assert lat[300] == lat[301] == common.FAILED_LATENCY_S > lat[out["ok"]].max()
    assert not out["ok"][300] and not out["ok"][301]
    assert st["requests"] == n and st["p99_ms"] >= 1e3 * stall - 30


def test_an_answer_that_never_comes_is_unanswered():
    class Silent(FakeGateway):
        def submit(self, basket):
            fut = super().submit(basket)
            return Future() if self.n == 3 else fut

    run = open_loop.run_schedule(Silent(-1, 0, -1, -1), np.arange(5) * 0.001, np.zeros((5, 2), np.uint32),
                                 seconds=0.01, drain_s=0.05)
    assert run["stats"]["unanswered"] == 1 and run["stats"]["failed"] == 1
    assert run["outcome"]["latency"][2] == common.FAILED_LATENCY_S
