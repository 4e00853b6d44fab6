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

- ``candidate_gen``   — host-side k-itemset join + prune from the (k-1) survivors
- ``candidate_join``  — its join (inside ``candidate_gen``)
- ``candidate_prune`` — its downward-closure prune (inside ``candidate_gen``)
- ``cand_place``      — a dense pass's candidate encode and copy to the device
- ``prefetch_stall``  — time the fold blocked on the chunk iterator
- ``count_kernel``    — on a card, the device span of the count launches by
                        CUDA events, read after the pass's own sync: a dense
                        pass's one count launch, but a streamed chunk's
                        accumulate step with the device's waits for the host
                        between its launches (launch-bound there, so not
                        kernel time); host time on the CPU
- ``host_sync``       — device→host sync of the counts (waits for the launches)
- ``checkpoint_write``— mid-level cursor/accumulator saves
- ``rules_extract``, ``rules_sort``, ``rules_pad`` — ``compile_rulebook``'s
  rule extraction, score sort and padding
- ``rulebook_place``  — ``place_rulebook``'s copies to the device

Call sites time a phase with ``with phase(obs, name):`` (a no-op for
``obs=None``); it reports through the observer's ``add_phase`` hook and,
while a profiler records on the thread, is a ``record_function`` range
named ``mine.<phase>``.  ``DeviceTimer`` times launches by CUDA events.
"""

from __future__ import annotations

import sys
import time
from contextlib import nullcontext
from typing import Optional

import torch

from .registry import MetricsRegistry
from .trace import Span, Tracer, mirror, unmirror

PHASES = ("candidate_gen", "prefetch_stall", "count_kernel", "host_sync",
          "checkpoint_write", "candidate_join", "candidate_prune", "cand_place",
          "rules_extract", "rules_sort", "rules_pad", "rulebook_place")

_NULL = nullcontext()


class _Phase:
    __slots__ = ("obs", "name", "t0", "rf")

    def __init__(self, obs, name: str):
        self.obs, self.name = obs, name

    def __enter__(self):
        self.rf = mirror(f"mine.{self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        unmirror(self.rf)
        self.obs.add_phase(self.name, self.t0, t1)


def phase(obs, name: str):
    """``with phase(obs, name):`` times the block as phase ``name`` through
    ``obs.add_phase``; nothing at all for ``obs=None``."""
    return _NULL if obs is None else _Phase(obs, name)


class DeviceTimer:
    """A phase's device time: each ``with timer:`` block's launches are
    bracketed by CUDA events on the device's current stream, and
    :meth:`flush` reports each block whose end event has completed as
    ``add_phase(name, t, t + elapsed)``, anchored at its enqueue on the host
    clock.  Call it after a sync the caller makes anyway: it never waits.
    A block's span holds whatever the device waits for between its
    launches, the host's launches included, so it is kernel time only when
    the device is never starved inside the block.  On the CPU each block is
    its host time, reported at once."""

    def __init__(self, obs, name: str, device):
        self.obs, self.name = obs, name
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._open: list = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e0.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if not self.cuda:
            self.obs.add_phase(self.name, self._t0, time.perf_counter())
            return
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(torch.cuda.current_stream(self.device))
        self._open.append((self._t0, self._e0, e1))

    def flush(self) -> None:
        while self._open and self._open[0][2].query():
            t0, e0, e1 = self._open.pop(0)
            self.obs.add_phase(self.name, t0, t0 + e0.elapsed_time(e1) / 1e3)


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def flush(self) -> None:
        pass


_NULL_TIMER = _NullTimer()


def device_timer(obs, name: str, device):
    """A :class:`DeviceTimer` of phase ``name``; one that does nothing for
    ``obs=None``."""
    return _NULL_TIMER if obs is None else DeviceTimer(obs, name, device)


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
        self._pending: list = []   # traced phases that ran with no level open

    # -- level lifecycle ---------------------------------------------------

    def on_level_start(self, level: int, candidates: int) -> None:
        self.registry.counter("mine_levels").inc()
        self.registry.counter("mine_candidates_total").inc(candidates)
        self.registry.counter("mine_candidates", {"level": str(level)}).inc(candidates)
        if self.tracer is not None:
            self._level_span = self.tracer.root("mine.level", level=level,
                                                candidates=candidates)
            # the level's candidate generation ran before it was named
            pending, self._pending = self._pending, []
            if pending:
                self._level_span.t0 = min(self._level_span.t0, pending[0][1])
            for p, t0, t1 in pending:
                self.tracer.add_span(self._level_span, f"mine.{p}", t0, t1)
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
        phase's cumulative wall-time and, when tracing, the level trace: a
        phase that runs with no level open (candidate generation, rule
        compile) joins the next level to start, or is a root of its own at
        :meth:`finish`."""
        self.registry.gauge("mine_phase_seconds", {"phase": phase}).inc(t1 - t0)
        if self.tracer is None:
            return
        if self._level_span is not None:
            self.tracer.add_span(self._level_span, f"mine.{phase}", t0, t1)
        else:
            self._pending.append((phase, t0, t1))

    def on_candidates_joined(self, level: int, joined: int) -> None:
        """Rows out of level ``level``'s join, before the prune."""
        self.registry.counter("mine_candidates_joined", {"level": str(level)}).inc(joined)

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
        pending, self._pending = self._pending, []
        if pending:   # after the last level: its empty join, the rule compile
            job = self.tracer.root("mine.job", force=True)
            job.t0 = pending[0][1]
            for p, t0, t1 in pending:
                self.tracer.add_span(job, f"mine.{p}", t0, t1)
            job.end()
        if self.progress is not None:
            self.progress.finish()
