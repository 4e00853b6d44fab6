"""Serving-side supervision: restart dead gateway dispatch workers.

The gateway's micro-batcher runs ONE dispatch worker thread; if that thread
dies (a bug outside the per-group exception fence, an injected fault), every
queued request would hang forever — the exact failure mode the paper's
JobTracker answers by re-arming a dead TaskTracker's work. The
:class:`WorkerSupervisor` polls the worker's liveness and, on death, calls
``MicroBatcher.restart_worker()``: the futures of the batch that was
IN FLIGHT inside the dead worker are failed explicitly (with the
:class:`~repro_torch.serving.batcher.WorkerCrashed` cause — a client sees an
error, never a hang), the admission queue is left intact and a fresh worker
thread re-arms it, and the restart lands in
``serving/metrics.py::worker_restarts``.

**Restart-storm guard.** A worker that crashes on every dispatch (a
poisoned request, a broken kernel) must not be restarted forever — Hadoop
blacklists a TaskTracker after repeated task failures for the same reason.
Both supervisors cap restarts per sliding window (``max_restarts`` within
``restart_window_s``) with exponential backoff between consecutive
restarts; past the cap the worker is declared DEAD: its batcher is closed
so every pending future fails explicitly (``WorkerCrashed``) and new
submits are refused (``AdmissionRejected``) — degraded loudly, never a
restart loop or a hang. The verdict is surfaced in :meth:`stats`.

:class:`ReplicaSetSupervisor` generalizes the same loop to N gateway
replicas (the serving router's replica set, DESIGN.md §12): one poll
thread, a per-replica storm guard, and callbacks so the router can track
replica health transitions (restarted → re-sync, gave up → dead).

Scope: supervision restarts the DISPATCH LOOP, not the device state — the
rulebook generations are immutable host/device records owned by the
gateway, so a restarted worker serves the same generation bit-for-bit.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class RestartGuard:
    """Sliding-window restart budget with exponential inter-restart backoff.

    ``allow(now)`` answers "may I restart right now?"; once the window holds
    ``max_restarts`` the guard gives up permanently (``gave_up``) — the
    supervisor's cue to declare the worker dead."""

    def __init__(self, max_restarts: int = 5, window_s: float = 10.0,
                 backoff_s: float = 0.05, backoff_multiplier: float = 2.0):
        if max_restarts < 1:
            raise ValueError("max_restarts must be >= 1")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff_s = float(backoff_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self._history: deque[float] = deque()
        self._next_allowed = 0.0
        self.gave_up = False

    def _prune(self, now: float) -> None:
        while self._history and self._history[0] < now - self.window_s:
            self._history.popleft()

    def allow(self, now: float) -> bool:
        if self.gave_up:
            return False
        self._prune(now)
        if len(self._history) >= self.max_restarts:
            self.gave_up = True          # restart storm: stop re-arming
            return False
        return now >= self._next_allowed

    def record(self, now: float) -> None:
        """Count one restart and push the next one out by the backoff."""
        self._history.append(now)
        self._next_allowed = now + self.backoff_s * (
            self.backoff_multiplier ** (len(self._history) - 1)
        )

    @property
    def window_restarts(self) -> int:
        return len(self._history)


def _give_up(batcher) -> None:
    """Declare a worker dead: close its batcher so every pending future
    fails explicitly (in-flight AND queued -> WorkerCrashed) and new
    submits are refused — a dead replica sheds load, it never hangs it."""
    batcher.close(timeout=1.0)


class WorkerSupervisor:
    """Poll a gateway's dispatch worker; restart it when it dies.

    Context-managed::

        with Gateway(rb) as gw, WorkerSupervisor(gw):
            ...

    ``restarts`` counts successful restarts (also mirrored into the
    gateway's metrics by ``restart_worker`` itself); ``dead`` is True once
    the restart-storm guard gave up and the worker was declared dead.
    """

    def __init__(self, gateway, poll_interval_s: float = 0.02, *,
                 max_restarts: int = 5, restart_window_s: float = 10.0,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_multiplier: float = 2.0):
        self._batcher = gateway._batcher
        self._interval = float(poll_interval_s)
        self._guard = RestartGuard(max_restarts, restart_window_s,
                                   restart_backoff_s, restart_backoff_multiplier)
        self._stop = threading.Event()
        self.restarts = 0
        self.dead = False
        self._thread = threading.Thread(
            target=self._run, name="gateway-supervisor", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            if self._batcher.closed or self.dead:
                continue            # shutdown is not a crash
            if self._batcher.worker_alive:
                continue
            now = time.perf_counter()
            if self._guard.allow(now):
                if self._batcher.restart_worker():
                    self.restarts += 1
                    self._guard.record(now)
            elif self._guard.gave_up:
                self.dead = True
                _give_up(self._batcher)

    def stats(self) -> dict:
        return {
            "restarts": self.restarts,
            "dead": self.dead,
            "window_restarts": self._guard.window_restarts,
        }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "WorkerSupervisor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class ReplicaSetSupervisor:
    """One supervision loop over N gateway replicas (DESIGN.md §12).

    The router's JobTracker: polls every replica's dispatch worker, re-arms
    dead ones through a per-replica :class:`RestartGuard`, and past the
    storm cap declares the REPLICA dead (batcher closed — pending futures
    fail explicitly, the router's failover re-routes them). ``on_restarted``
    / ``on_gave_up`` callbacks let the owner (the router) drive its health
    state machine and re-sync a revived replica's rulebook generation.
    """

    def __init__(self, gateways, poll_interval_s: float = 0.02, *,
                 max_restarts: int = 5, restart_window_s: float = 10.0,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_multiplier: float = 2.0,
                 on_restarted=None, on_gave_up=None):
        self._batchers = [gw._batcher for gw in gateways]
        self._interval = float(poll_interval_s)
        self._guards = [
            RestartGuard(max_restarts, restart_window_s,
                         restart_backoff_s, restart_backoff_multiplier)
            for _ in self._batchers
        ]
        self._on_restarted = on_restarted
        self._on_gave_up = on_gave_up
        self._stop = threading.Event()
        self.restarts = [0] * len(self._batchers)
        self.dead = [False] * len(self._batchers)
        self._thread = threading.Thread(
            target=self._run, name="replica-set-supervisor", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            for i, b in enumerate(self._batchers):
                if b.closed or self.dead[i] or b.worker_alive:
                    continue
                now = time.perf_counter()
                guard = self._guards[i]
                if guard.allow(now):
                    if b.restart_worker():
                        self.restarts[i] += 1
                        guard.record(now)
                        if self._on_restarted is not None:
                            self._on_restarted(i)
                elif guard.gave_up:
                    self.dead[i] = True
                    _give_up(b)
                    if self._on_gave_up is not None:
                        self._on_gave_up(i)

    def stats(self) -> dict:
        return {
            "restarts": list(self.restarts),
            "dead": list(self.dead),
            "window_restarts": [g.window_restarts for g in self._guards],
        }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ReplicaSetSupervisor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
