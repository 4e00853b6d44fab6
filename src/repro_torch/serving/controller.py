"""p99-targeted adaptive ``max_wait`` controller for the micro-batcher (§14).

The batcher's ``max_wait_ms`` trades straggler-coalescing (throughput,
batch occupancy) against added queueing latency.  A fixed value is tuned
for one load shape; this controller closes the loop against the latency
SLO instead: it watches the *windowed* p99 of the gateway latency
histogram (differencing bucket counts between control ticks, the same
trick the SLO evaluator uses) and steers the wait with **bounded AIMD**:

* p99 over the objective   → multiplicative decrease (halve the wait) —
  back off hard, the objective is burning;
* p99 under ``headroom × objective`` → additive increase (one small step)
  — cheap exploration toward better batching while the budget is slack;
* in the dead band between → hold.

Both directions clamp to ``[min_wait_ms, max_wait_ms]``, so the controller
can never wait longer than the configured ceiling nor go below the greedy
floor — a broken signal degrades to a fixed-wait batcher, never to an
unbounded one.

**Bit-identity is untouched** (§10 contract): the wait only changes *which
requests land in the same batch*, i.e. dispatch timing.  Every response is
still computed by the same padded-bucket match + top-k as
``recommend(basket, top_k, batch_size=response.bucket)`` for its
generation, so responses remain bit-identical regardless of what the
controller does.  That is why this knob — and only this knob — is safe to
drive from a feedback loop.

The batcher calls :meth:`AdaptiveMaxWait.current_wait_s` once per batch;
the controller re-evaluates at most every ``interval_s`` and only when the
window holds ``min_samples`` fresh observations (a p99 of three requests
is noise, not signal).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from repro_torch.obs.registry import Histogram


class AdaptiveMaxWait:
    """Bounded-AIMD ``max_wait`` controller driven by windowed p99."""

    def __init__(
        self,
        histogram: Histogram,
        *,
        objective_ms: float,
        initial_wait_ms: float,
        min_wait_ms: float = 0.0,
        max_wait_ms: Optional[float] = None,
        decrease_factor: float = 0.5,
        increase_ms: float = 0.25,
        interval_s: float = 0.25,
        headroom: float = 0.8,
        min_samples: int = 16,
        now_fn: Callable[[], float] = time.perf_counter,
    ):
        if objective_ms <= 0:
            raise ValueError("objective_ms must be positive")
        if not 0.0 < decrease_factor < 1.0:
            raise ValueError("decrease_factor must be in (0, 1)")
        if not 0.0 < headroom <= 1.0:
            raise ValueError("headroom must be in (0, 1]")
        self._hist = histogram
        self.objective_ms = float(objective_ms)
        self.min_wait_ms = max(0.0, float(min_wait_ms))
        self.max_wait_ms = (float(max_wait_ms) if max_wait_ms is not None
                            else float(initial_wait_ms))
        if self.max_wait_ms < self.min_wait_ms:
            raise ValueError("max_wait_ms must be >= min_wait_ms")
        self._decrease = float(decrease_factor)
        self._increase_ms = float(increase_ms)
        self._interval_s = float(interval_s)
        self._headroom = float(headroom)
        self._min_samples = int(min_samples)
        self._now = now_fn
        self._lock = threading.Lock()
        self._wait_ms = min(max(float(initial_wait_ms), self.min_wait_ms),
                            self.max_wait_ms)
        self._last_tick = self._now()
        self._last_counts, self._last_count = self._baseline()
        self.ticks = 0          # control decisions taken (observability)
        self.decreases = 0
        self.increases = 0
        self.last_window_p99_ms = float("nan")

    def _baseline(self):
        counts, count, _, _, _ = self._hist._state()
        return counts, count

    # ------------------------------------------------------------- control --
    def current_wait_s(self) -> float:
        """The batcher's per-batch hook: maybe tick, then return the wait."""
        now = self._now()
        with self._lock:
            if now - self._last_tick >= self._interval_s:
                self._tick_locked(now)
            return self._wait_ms / 1e3

    @property
    def current_wait_ms(self) -> float:
        with self._lock:
            return self._wait_ms

    def force_tick(self) -> None:
        """Evaluate immediately regardless of the interval (tests)."""
        with self._lock:
            self._tick_locked(self._now())

    def _tick_locked(self, now: float) -> None:
        counts, count = self._baseline()
        delta_count = count - self._last_count
        if delta_count < self._min_samples:
            # not enough fresh signal: hold, but do NOT reset the window —
            # a trickle of requests still accumulates toward min_samples
            self._last_tick = now
            return
        delta = [c - o for c, o in zip(counts, self._last_counts)]
        p99_s = Histogram._quantile_from(delta, delta_count, math.inf, 0.99)
        self._last_counts, self._last_count = counts, count
        self._last_tick = now
        self.ticks += 1
        p99_ms = p99_s * 1e3
        self.last_window_p99_ms = p99_ms
        if p99_ms > self.objective_ms:
            new = max(self.min_wait_ms, self._wait_ms * self._decrease)
            if new != self._wait_ms:
                self.decreases += 1
            self._wait_ms = new
        elif p99_ms < self.objective_ms * self._headroom:
            new = min(self.max_wait_ms, self._wait_ms + self._increase_ms)
            if new != self._wait_ms:
                self.increases += 1
            self._wait_ms = new
        # dead band [headroom*objective, objective]: hold steady

    # -------------------------------------------------------------- status --
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "wait_ms": self._wait_ms,
                "objective_ms": self.objective_ms,
                "window_p99_ms": self.last_window_p99_ms,
                "ticks": self.ticks,
                "increases": self.increases,
                "decreases": self.decreases,
                "min_wait_ms": self.min_wait_ms,
                "max_wait_ms": self.max_wait_ms,
            }
