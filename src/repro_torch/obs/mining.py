"""Mining job counters + live progress, Hadoop style (§13).

The paper's Hadoop deployment got phase attribution for free from the
framework's job counters and task-progress reporting; :class:`MiningObs` is
that layer for our streamed miner.  It bundles a :class:`MetricsRegistry`
(per-level candidate/frequent counters, chunk/row counters, per-phase
wall-time split, partition retry/speculation counters), an optional
:class:`Tracer` (each mined level is one trace: candidate-gen / count-pass /
chunk phases nest under it), and an optional :class:`MiningProgress`
reporter that prints throughput + ETA while a multi-minute mine streams.

Everything is observation-only.  Call sites guard with ``if obs is not
None`` so the uninstrumented path stays untouched, and nothing here feeds
back into mining decisions — mined dicts are bit-identical with obs on/off
(CI-enforced).

Phase taxonomy (the per-phase wall-time split):

- ``candidate_gen``   — host-side k-itemset join from the (k-1) survivors
- ``prefetch_stall``  — time the fold blocked on the chunk iterator
- ``count_kernel``    — enqueue of the chunk's count launches (asynchronous)
- ``host_sync``       — final device→host sync of the level's counts (waits for the launches)
- ``checkpoint_write``— mid-level cursor/accumulator saves
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .registry import MetricsRegistry
from .trace import Span, Tracer

PHASES = ("candidate_gen", "prefetch_stall", "count_kernel", "host_sync",
          "checkpoint_write")


class MiningProgress:
    """Throttled live progress lines: level, chunks, rows/s, ETA of the
    current pass.  Writes plain newline-terminated lines (CI-log safe)."""

    def __init__(self, total_rows: Optional[int] = None, out=None,
                 interval_s: float = 0.5):
        self.total_rows = total_rows
        self.out = out if out is not None else sys.stderr
        self.interval_s = float(interval_s)
        self._t_start = time.perf_counter()
        self._t_last = 0.0
        self._level = 0
        self._candidates = 0
        self._pass_rows = 0
        self._pass_t0 = self._t_start
        self.lines_emitted = 0

    def _emit(self, force: bool = False) -> None:
        now = time.perf_counter()
        if not force and (now - self._t_last) < self.interval_s:
            return
        self._t_last = now
        dt = max(now - self._pass_t0, 1e-9)
        rate = self._pass_rows / dt
        msg = (f"[mine] L{self._level} cand={self._candidates} "
               f"rows={self._pass_rows} ({rate / 1e3:.1f}k rows/s)")
        if self.total_rows:
            frac = min(1.0, self._pass_rows / self.total_rows)
            eta = (self.total_rows - self._pass_rows) / rate if rate > 0 else 0.0
            msg += f" {frac * 100:5.1f}% eta={eta:.1f}s"
        self.out.write(msg + "\n")
        try:
            self.out.flush()
        except Exception:
            pass
        self.lines_emitted += 1

    def on_level_start(self, level: int, candidates: int) -> None:
        self._level = level
        self._candidates = candidates
        self._pass_rows = 0
        self._pass_t0 = time.perf_counter()
        self._emit(force=True)

    def on_rows(self, rows: int) -> None:
        self._pass_rows += rows
        self._emit()

    def on_level_end(self, level: int, frequent: int) -> None:
        dt = time.perf_counter() - self._pass_t0
        self.out.write(f"[mine] L{level} done: {frequent} frequent "
                       f"({dt:.2f}s)\n")
        self.lines_emitted += 1

    def finish(self) -> None:
        dt = time.perf_counter() - self._t_start
        self.out.write(f"[mine] finished in {dt:.2f}s\n")
        self.lines_emitted += 1


class MiningObs:
    """Job counters + phase timers + optional tracing for one mine run."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 progress: Optional[MiningProgress] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.progress = progress
        self._level_span: Optional[Span] = None

    # -- level lifecycle ---------------------------------------------------

    def on_level_start(self, level: int, candidates: int) -> None:
        self.registry.counter("mine_levels").inc()
        self.registry.counter("mine_candidates_total").inc(candidates)
        self.registry.counter("mine_candidates", {"level": str(level)}).inc(candidates)
        if self.tracer is not None:
            self._level_span = self.tracer.root("mine.level", level=level,
                                                candidates=candidates)
        if self.progress is not None:
            self.progress.on_level_start(level, candidates)

    def on_level_end(self, level: int, frequent: int) -> None:
        self.registry.counter("mine_frequent_total").inc(frequent)
        self.registry.counter("mine_frequent", {"level": str(level)}).inc(frequent)
        if self._level_span is not None:
            self._level_span.end(frequent=frequent)
            self._level_span = None
        if self.progress is not None:
            self.progress.on_level_end(level, frequent)

    # -- phase + chunk accounting -----------------------------------------

    def add_phase(self, phase: str, t0: float, t1: float) -> None:
        """Fold one measured interval (``perf_counter`` endpoints) into the
        phase's cumulative wall-time and, when tracing, the level trace."""
        self.registry.gauge("mine_phase_seconds", {"phase": phase}).inc(t1 - t0)
        if self.tracer is not None and self._level_span is not None:
            self.tracer.add_span(self._level_span, f"mine.{phase}", t0, t1)

    def on_chunk(self, rows: int) -> None:
        self.registry.counter("mine_chunks_streamed").inc()
        self.registry.counter("mine_rows_streamed").inc(rows)
        if self.progress is not None:
            self.progress.on_rows(rows)

    def observe_max_candidate_bucket(self, kp: int) -> None:
        self.registry.gauge("mine_max_candidate_bucket").max(kp)

    # -- fault-tolerance accounting (run_partitions) -----------------------

    def on_partition_attempt(self, retry: bool, speculative: bool) -> None:
        self.registry.counter("mine_partition_attempts").inc()
        if retry:
            self.registry.counter("mine_partition_retries").inc()
        if speculative:
            self.registry.counter("mine_speculative_issued").inc()

    def on_partition_done(self, speculative_win: bool) -> None:
        self.registry.counter("mine_partitions_completed").inc()
        if speculative_win:
            self.registry.counter("mine_speculative_wins").inc()

    def on_partition_skipped(self) -> None:
        self.registry.counter("mine_partitions_skipped").inc()

    # -- exposition --------------------------------------------------------

    def counters(self) -> dict:
        """One atomic Hadoop-style job-counter dump (plain dict)."""
        return self.registry.snapshot()

    def finish(self) -> None:
        if self.progress is not None:
            self.progress.finish()
