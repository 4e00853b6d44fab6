"""Micro-batching request scheduler for the serving gateway (DESIGN.md §10).

Concurrently arriving single-basket queries land in ONE bounded queue; a
single worker thread pops the oldest request, then coalesces everything that
is already queued — waiting at most ``max_wait_ms`` for stragglers — into a
batch of at most ``max_batch``, and hands it (grouped by ``top_k``, arrival
order preserved) to the gateway's dispatch function, which pads to the
power-of-two bucket and demultiplexes per-request futures.

``max_wait_ms = 0`` is the pure **greedy** policy: a lone request dispatches
immediately (no artificial latency floor), while a busy device back-builds
batches naturally because the queue fills during the previous dispatch —
the batching/throughput trade Singh et al. measure at the *job scheduling*
layer of MapReduce-Apriori, transplanted to the query side.

Backpressure is explicit: a full queue raises :class:`AdmissionRejected` at
``submit`` (counted in metrics) — overload degrades by refusing admission,
never by silently dropping an accepted request. A dispatch that throws
resolves every future in the group with that exception for the same reason.
A request carrying a ``deadline`` that passes while it sits in the queue is
dropped at dispatch time with :class:`DeadlineExceeded` (DESIGN.md §12) —
the device never works for a caller that has already given up.

Supervision (DESIGN.md §11): the worker publishes its liveness
(``worker_alive``) and the batch it is holding (``_inflight``), and
``restart_worker()`` re-arms a dead worker — the futures of the stranded
in-flight batch are failed with :class:`WorkerCrashed` (a client sees an
error, never a hang), every still-QUEUED request survives untouched for the
fresh worker to drain, and the restart is counted in
``metrics.worker_restarts``. ``distributed.supervisor.WorkerSupervisor``
drives this loop.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

_SENTINEL = object()


class AdmissionRejected(RuntimeError):
    """The gateway refused the request at admission (bounded-queue overload
    or shutdown). ``reason`` says which."""

    def __init__(self, reason: str):
        super().__init__(f"request rejected: {reason}")
        self.reason = reason


class WorkerCrashed(RuntimeError):
    """The dispatch worker died while this request was in flight; the
    request was NOT served (retrying it is safe — matching is read-only)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it was served. Expired requests
    are dropped at DISPATCH time — a request whose caller has given up never
    spends device time — and their futures fail with this, never hang."""


@dataclasses.dataclass
class Request:
    """One admitted basket query travelling through the batcher."""

    packed: np.ndarray        # (W,) uint32 basket bitset row
    top_k: int
    future: Future            # resolves to a gateway Response
    t_submit: float           # perf_counter at admission (latency accounting)
    deadline: float | None = None   # absolute perf_counter time; expired
                                    # requests are dropped at dispatch
    span: object | None = None      # sampled obs.trace.Span carrying trace
                                    # context through the batcher (§13);
                                    # None for the unsampled fast path


class MicroBatcher:
    """Bounded-queue scheduler: one worker thread, coalesced dispatches."""

    def __init__(
        self,
        dispatch_fn,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        queue_depth: int = 1024,
        metrics=None,
        wait_controller=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._dispatch_fn = dispatch_fn
        # perf_counter time the batch being dispatched left the queue (its
        # first take; for a later top_k group of it, when the group before
        # returned), set before each dispatch_fn call, so the dispatcher can
        # time the collect
        self.collect_start = 0.0
        self._max_batch = int(max_batch)
        self._max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        # optional serving.controller.AdaptiveMaxWait: consulted once per
        # batch for the straggler wait. Only dispatch TIMING changes — which
        # requests coalesce — so response bit-identity is untouched (§14)
        self._wait_controller = wait_controller
        self._metrics = metrics
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._closed = False
        # serializes (closed check + enqueue) against (close + sentinel):
        # an admitted request is always queued AHEAD of the sentinel, so the
        # worker is guaranteed to reach it — admitted ⇒ resolved
        self._admit_lock = threading.Lock()
        # _inflight has its OWN lock: the worker must never need the admit
        # lock (close() holds it across a blocking put while the worker drains)
        self._inflight_lock = threading.Lock()
        self._inflight: list = []
        self._crash_hook = None   # test/fault-injection seam, called in-worker
        self._worker = threading.Thread(target=self._run, name="gateway-batcher", daemon=True)
        self._worker.start()

    @property
    def depth(self) -> int:
        """Requests currently queued (admission-pressure signal)."""
        return self._q.qsize()

    @property
    def capacity(self) -> int:
        """Admission-queue bound — the denominator brownout shedding uses."""
        return self._q.maxsize

    @property
    def current_max_wait_ms(self) -> float:
        """The effective straggler wait: live controller value when adaptive,
        else the fixed configuration."""
        if self._wait_controller is not None:
            return self._wait_controller.current_wait_ms
        return self._max_wait_s * 1e3

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def worker_alive(self) -> bool:
        """Liveness of the dispatch worker — the supervisor's poll target."""
        return self._worker.is_alive()

    def submit(self, request: Request) -> None:
        """Admit one request or raise :class:`AdmissionRejected`."""
        with self._admit_lock:
            if self._closed:
                self._reject("gateway closed")
            try:
                self._q.put_nowait(request)
            except queue.Full:
                self._reject("admission queue full")
        if self._metrics is not None:
            self._metrics.record_admission(True)

    def _reject(self, reason: str):
        if self._metrics is not None:
            self._metrics.record_admission(False)
        raise AdmissionRejected(reason)

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop admitting, flush every already-admitted request, join.

        The admit lock makes close/submit race-free: the sentinel is
        enqueued strictly after every admitted request, so the worker flushes
        all of them before exiting — no admitted future is ever left hanging.
        Closing with a DEAD (unsupervised) worker fails the stranded futures
        explicitly instead of waiting on a join that can never finish.
        """
        with self._admit_lock:
            if self._closed:
                return
            self._closed = True
            if not self._worker.is_alive():
                self._fail_stranded("gateway closed with a dead worker")
                return
            # blocking put is safe: the worker keeps draining ahead of it,
            # and submitters blocked on the lock will see _closed afterwards
            self._q.put(_SENTINEL)
        self._worker.join(timeout=timeout)

    # -------------------------------------------------------- supervision --
    def restart_worker(self) -> bool:
        """Re-arm a dead dispatch worker (the supervisor's repair action).

        The stranded in-flight batch's futures are failed with
        :class:`WorkerCrashed` — ONLY those; every still-queued request is
        untouched and drains through the fresh worker. Returns True when a
        restart happened (counted in ``metrics.worker_restarts``), False if
        the batcher is closed or the worker turned out to be alive.
        """
        with self._admit_lock:
            if self._closed or self._worker.is_alive():
                return False
            self._fail_stranded("dispatch worker crashed mid-batch")
            self._worker = threading.Thread(
                target=self._run, name="gateway-batcher", daemon=True
            )
            self._worker.start()
        if self._metrics is not None:
            self._metrics.record_worker_restart()
        return True

    def _fail_stranded(self, reason: str) -> None:
        with self._inflight_lock:
            stranded, self._inflight = self._inflight, []
        if self._closed:   # a closed batcher also strands whatever is queued
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    stranded.append(item)
        for r in stranded:
            if not r.future.done():
                # span first, future second: whoever awaits the future ends
                # the PARENT span on wake, so the child must close before
                if r.span is not None:
                    r.span.end(outcome="worker_crashed")
                r.future.set_exception(WorkerCrashed(reason))
                if self._metrics is not None:
                    self._metrics.record_response(0.0, failed=True)

    # ------------------------------------------------------------- worker --
    def _run(self) -> None:
        stop = False
        while not stop:
            item = self._q.get()
            self.collect_start = time.perf_counter()
            if item is _SENTINEL:
                break
            batch = [item]
            wait_s = (self._wait_controller.current_wait_s()
                      if self._wait_controller is not None else self._max_wait_s)
            deadline = time.perf_counter() + wait_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    # past the deadline we still drain whatever is already
                    # queued (free batching), we just stop *waiting*
                    nxt = self._q.get_nowait() if remaining <= 0 else self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch_tracked(batch)
        # defensive flush: the admit lock orders every admitted request
        # ahead of the sentinel, so this drain should always be empty
        tail = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                tail.append(item)
        for start in range(0, len(tail), self._max_batch):
            self.collect_start = time.perf_counter()
            self._dispatch_tracked(tail[start : start + self._max_batch])

    def _drop_expired(self, batch: list) -> list:
        """Fail past-deadline requests with :class:`DeadlineExceeded` at
        dispatch time — the queue bounds a caller's WAIT via
        ``future.result(timeout)``, but only this bounds the REQUEST: an
        abandoned query must not spend device time."""
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                if not r.future.done():
                    if r.span is not None:   # close before waking the waiter
                        r.span.end(outcome="deadline_expired")
                    r.future.set_exception(DeadlineExceeded(
                        f"deadline passed {(now - r.deadline) * 1e3:.1f} ms "
                        f"before dispatch (queued {(now - r.t_submit) * 1e3:.1f} ms)"
                    ))
                    if self._metrics is not None:
                        self._metrics.record_deadline_expired()
                        self._metrics.record_response(0.0, failed=True)
            else:
                live.append(r)
        return live

    def _dispatch_tracked(self, batch: list) -> None:
        """Dispatch with the batch registered as in-flight: if the worker
        dies anywhere in here, ``restart_worker`` knows exactly which
        futures were stranded. The crash hook is the fault-injection seam —
        it runs WITH the batch in flight, so an injected death exercises the
        real stranding path."""
        batch = self._drop_expired(batch)
        if not batch:
            return
        with self._inflight_lock:
            self._inflight = list(batch)
        # deliberately NOT try/finally: on a crash the batch must STAY
        # registered as in-flight so restart_worker can fail its futures
        if self._crash_hook is not None:
            self._crash_hook(batch)
        self._dispatch_batch(batch)
        with self._inflight_lock:
            self._inflight = []

    def _dispatch_batch(self, batch: list) -> None:
        """Group by top_k (one top-k width per launch) and dispatch; a
        throwing dispatch fails its group's futures, never drops them."""
        groups: dict[int, list] = {}
        for r in batch:
            groups.setdefault(r.top_k, []).append(r)
        for group in groups.values():
            try:
                self._dispatch_fn(group)
            except BaseException as e:  # noqa: BLE001 — must reach the futures
                for r in group:
                    if r.span is not None:   # close before waking the waiter
                        r.span.end(outcome="dispatch_error")
                    if not r.future.done():
                        r.future.set_exception(e)
                        if self._metrics is not None:
                            self._metrics.record_response(0.0, failed=True)
            self.collect_start = time.perf_counter()
