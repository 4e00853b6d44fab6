"""Retryable partition execution — Hadoop task re-execution for SON phase 1.

The paper's whole case for Map/Reduce is that a map task which dies is simply
re-executed from its replicated split; "Observations on Factors Affecting
Performance of MapReduce based Apriori" (1701.05982) adds that stragglers on
heterogeneous nodes dominate wall-clock, which Hadoop answers with
speculative execution. This module is both mechanisms for the mining stack's
real phase-1 executor (DESIGN.md §11): SON partitions (= the store's on-disk
shards) are dispatched through a bounded-retry work queue over a thread
pool —

  * a failed partition (shard read error, injected fault, worker exception)
    is retried with exponential backoff, up to ``max_retries`` re-executions;
  * a straggling partition is speculatively re-issued to an idle worker once
    it has run ``speculative_factor``× the median completed-task time
    (first completion wins; duplicates are discarded);
  * a partition that exhausts its retries either raises
    :class:`PartitionFailure` naming the partition (default) or — in
    ``on_exhausted="skip"`` mode — is recorded in the :class:`FaultReport`
    and the mine continues with an EXPLICITLY reported gap.

Partitions must be *re-loadable by index* (the worker takes the partition
number, not the data) — exactly the property the on-disk store's shards
have, and the analogue of HDFS split replication.

The PyTorch port's copy of the JAX package's executor (stdlib only).  The
port's SON mappers mine on the card, so with ``max_workers > 1`` several
threads launch kernels at once; results do not depend on that.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

_UNSET = object()


class PartitionFailure(RuntimeError):
    """A partition exhausted its retries. Names the partition and keeps the
    last underlying exception as ``__cause__``/``cause``."""

    def __init__(self, partition: int, attempts: int, cause: BaseException):
        super().__init__(
            f"partition {partition} failed after {attempts} attempt(s): {cause!r}"
        )
        self.partition = partition
        self.attempts = attempts
        self.cause = cause


class InjectedFailure(RuntimeError):
    """Raised by failure injectors to emulate a lost map task."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Policy knobs of the retrying partition executor."""

    max_retries: int = 2              # re-executions after the first attempt
    backoff_s: float = 0.02           # sleep before retry #1
    backoff_multiplier: float = 2.0   # backoff_s * mult**(attempt-1)
    max_workers: int = 2              # thread-pool width (peak RAM ~ workers * shard)
    speculative: bool = True          # re-issue stragglers to idle workers
    speculative_factor: float = 4.0   # straggler = runtime > factor * median done
    on_exhausted: str = "raise"       # "raise" | "skip" (explicit-report gap)
    failure_injector: Callable | None = None   # (partition, attempt) -> may raise

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if self.on_exhausted not in ("raise", "skip"):
            raise ValueError(f"on_exhausted must be raise|skip, got {self.on_exhausted!r}")


@dataclasses.dataclass
class FaultReport:
    """What the executor actually did — published, never silent."""

    attempts: dict = dataclasses.field(default_factory=dict)  # partition -> executions
    retries: int = 0                 # failure-triggered re-executions
    speculative_issued: int = 0      # straggler backup copies launched
    speculative_wins: int = 0        # partitions whose backup copy finished first
    skipped: tuple = ()              # partitions dropped in "skip" mode
    completed: int = 0

    @property
    def total_failures(self) -> int:
        return self.retries + len(self.skipped)

    def to_json(self) -> dict:
        return {
            "attempts": {int(k): int(v) for k, v in self.attempts.items()},
            "retries": self.retries,
            "speculative_issued": self.speculative_issued,
            "speculative_wins": self.speculative_wins,
            "skipped": [int(p) for p in self.skipped],
            "completed": self.completed,
        }


def retry_delay(fault: FaultConfig, attempt: int) -> float:
    """Backoff before re-execution ``attempt`` (0-based):
    ``backoff_s * backoff_multiplier**attempt``. Shared by the partition
    executor and the serving router's failover path — one retry policy
    object (:class:`FaultConfig`) drives both."""
    return fault.backoff_s * fault.backoff_multiplier**attempt


class _Task:
    __slots__ = ("idx", "attempt", "speculative")

    def __init__(self, idx: int, attempt: int, speculative: bool = False):
        self.idx = idx
        self.attempt = attempt
        self.speculative = speculative


def run_partitions(
    worker_fn: Callable[[int], object],
    num_partitions: int,
    fault: FaultConfig = FaultConfig(),
    obs=None,
) -> tuple[list, FaultReport]:
    """Execute ``worker_fn(p)`` for every partition through the retrying,
    speculating work queue; returns ``(results, report)`` with ``results[p]``
    being the partition's value (or None for a skipped partition).

    ``worker_fn`` must be idempotent and re-invokable (it re-reads its
    partition — the HDFS-split property); duplicate completions from
    speculative copies are discarded under a lock, first writer wins.

    ``obs`` (a mining observer with the JAX package's ``MiningObs`` hooks) mirrors the report into live
    Hadoop-style job counters — attempts, retries, speculative issues/wins,
    skips — purely observational: results are identical with obs on/off.
    """
    if num_partitions == 0:
        return [], FaultReport()
    results = [_UNSET] * num_partitions
    report = FaultReport(attempts={p: 0 for p in range(num_partitions)})
    lock = threading.Lock()
    done_evt = threading.Event()
    pending: list[_Task] = [_Task(p, 0) for p in range(num_partitions)]
    running: dict[int, float] = {}       # partition -> oldest running start time
    durations: list[float] = []          # completed-task wall times (for median)
    remaining = [num_partitions]         # partitions not yet done/skipped
    error: list = []                     # first PartitionFailure in "raise" mode

    def _finish_one():
        remaining[0] -= 1
        if remaining[0] <= 0:
            done_evt.set()

    def _next_task():
        with lock:
            if pending:
                t = pending.pop(0)
                running.setdefault(t.idx, time.perf_counter())
                return t
        return None

    def _run_task(t: _Task):
        if obs is not None:
            obs.on_partition_attempt(retry=t.attempt > 0, speculative=t.speculative)
        t0 = time.perf_counter()
        try:
            if fault.failure_injector is not None:
                fault.failure_injector(t.idx, t.attempt)
            value = worker_fn(t.idx)
        except BaseException as e:  # noqa: BLE001 — every failure is policy-handled
            with lock:
                report.attempts[t.idx] += 1
                if results[t.idx] is not _UNSET:
                    return          # a twin already completed it; failure moot
                if t.attempt < fault.max_retries:
                    report.retries += 1
                    running.pop(t.idx, None)   # restart the straggler clock
                    delay = retry_delay(fault, t.attempt)
                    retry = _Task(t.idx, t.attempt + 1)
                else:
                    running.pop(t.idx, None)
                    if fault.on_exhausted == "skip":
                        report.skipped = report.skipped + (t.idx,)
                        results[t.idx] = None
                        if obs is not None:
                            obs.on_partition_skipped()
                    elif not error:
                        error.append(PartitionFailure(t.idx, t.attempt + 1, e))
                        done_evt.set()
                    _finish_one()
                    return
            if delay > 0:
                time.sleep(delay)   # backoff outside the lock
            with lock:
                if results[t.idx] is _UNSET:
                    pending.append(retry)
            return
        dt = time.perf_counter() - t0
        with lock:
            report.attempts[t.idx] += 1
            won = results[t.idx] is _UNSET
            if won:
                results[t.idx] = value
                report.completed += 1
                if t.speculative:      # the backup copy beat the original
                    report.speculative_wins += 1
                durations.append(dt)
                running.pop(t.idx, None)
                _finish_one()
        if won and obs is not None:
            obs.on_partition_done(speculative_win=t.speculative)

    def _worker():
        while not done_evt.is_set():
            t = _next_task()
            if t is None:
                if done_evt.wait(timeout=0.005):
                    return
                continue
            _run_task(t)

    n_workers = min(fault.max_workers, num_partitions)
    threads = [
        threading.Thread(target=_worker, name=f"son-partition-{i}", daemon=True)
        for i in range(n_workers)
    ]
    for th in threads:
        th.start()

    # ---- the calling thread doubles as the speculation monitor -----------
    speculated: set[int] = set()
    while not done_evt.wait(timeout=0.01):
        if not fault.speculative:
            continue
        with lock:
            if pending or len(durations) < 1:
                continue            # no idle capacity signal / no baseline yet
            med = sorted(durations)[len(durations) // 2]
            now = time.perf_counter()
            for idx, started in list(running.items()):
                if (
                    idx not in speculated
                    and results[idx] is _UNSET
                    and now - started > fault.speculative_factor * max(med, 1e-4)
                ):
                    pending.append(_Task(idx, 0, speculative=True))
                    speculated.add(idx)
                    report.speculative_issued += 1
    # The job is complete once every partition has a recorded outcome. A
    # worker may still be parked inside a SUPERSEDED attempt (its twin
    # already won) — abandon it after a short grace, as Hadoop kills the
    # slower speculative attempt: the daemon thread's late completion is
    # discarded under the results lock, so it cannot change the outcome.
    for th in threads:
        th.join(timeout=0.05)

    if error:
        raise error[0]
    return [None if r is _UNSET else r for r in results], report
