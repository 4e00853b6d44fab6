"""Lightweight sampled span tracer with a perfetto-loadable exporter (§13).

A :class:`Tracer` hands out :class:`Span` objects carrying a trace-id (one
per sampled request / mine level) and a span-id, with parent nesting and
free-form attributes.  Finished spans land in a thread-safe ring buffer;
``export_chrome()`` renders them as Chrome trace-event JSON ("X" complete
events, microsecond timestamps) that https://ui.perfetto.dev loads directly.

Sampling is deterministic: with ``sample_rate=r`` every ``round(1/r)``-th
root is traced (the first root always is), so tests and CI smokes get
reproducible traces without a seeded RNG.  Unsampled call sites cost one
``None`` check — instrumentation stays inert when tracing is off, and every
helper (``child``/``end``/``add_span``) accepts ``None`` parents so call
sites never branch.

Span ends are idempotent: failure paths can ``end()`` a span that a success
path may also try to close, and only the first close is recorded.

**One clock with the device trace.**  The exporter writes ``ts`` on the
clock of ``torch.profiler``'s Chrome trace: Unix-epoch microseconds (the
profiler's ``ts`` plus ``baseTimeNanoseconds`` / 1e3), from an anchor pair
(``perf_counter``, ``time_ns``) taken at the tracer's epoch.  ``ts`` and
``dur`` are whole microseconds (``dur`` = rounded end − rounded start), so
a child still nests inside its parent at Unix-epoch magnitudes.  While a
profiler records, a span opened live (:meth:`Tracer.span`,
:meth:`Tracer.live`) is also a ``record_function`` range of its name, so
the profiler's trace carries the program's spans of the threads it records
(with ``profile_all_threads``, every thread's, the gateway's too);
back-dated spans (:meth:`Tracer.add_span`) and spans opened with
:meth:`Tracer.child`, which may end on another thread, are not mirrored.  With no profiler a live span pays one boolean
check.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def mirror(name: str):
    """A profiler range named ``name``, entered, while a ``torch.profiler``
    records; else ``None``.  Close it with :func:`unmirror` on the same
    thread, innermost first.  The check is the profiler module's flag, set
    on every thread (``torch.autograd._profiler_enabled()`` is False on a
    thread the profiler did not start from, and on every thread under
    ``profile_all_threads``); a range on a thread the profiler does not
    record is dropped by it."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def unmirror(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


class Span:
    """One timed operation.  ``end()`` is idempotent; attributes set at end
    merge over those set at start."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "t0", "t1", "attrs", "tid", "_ended", "_mirror")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: Optional[int], name: str, t0: float, attrs: dict):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs
        self.tid = threading.get_ident()
        self._ended = False
        self._mirror = None

    def child(self, name: str, **attrs) -> "Span":
        """Start a child span on the same trace (current time, this thread)."""
        return self.tracer._start(name, self.trace_id, self.span_id, attrs)

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        self.t1 = time.perf_counter()
        if self._mirror is not None and threading.get_ident() == self.tid:
            unmirror(self._mirror)
        self._mirror = None
        if attrs:
            self.attrs.update(attrs)
        self.tracer._finish(self)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class Tracer:
    """Sampled span factory + thread-safe ring buffer of finished spans."""

    def __init__(self, sample_rate: float = 1.0, capacity: int = 16384):
        self.sample_rate = float(sample_rate)
        self._period = 0 if self.sample_rate <= 0.0 else max(1, round(1.0 / self.sample_rate))
        self._lock = threading.Lock()
        self._roots_seen = 0
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._done = deque(maxlen=int(capacity))
        self._thread_names: Dict[int, str] = {}
        self.epoch = time.perf_counter()
        self.epoch_unix_ns = time.time_ns()   # the same instant on the profiler's clock
        self.sampled_roots = 0

    # -- span creation -----------------------------------------------------

    def _start(self, name: str, trace_id: int, parent_id: Optional[int],
               attrs: dict) -> Span:
        with self._lock:
            sid = next(self._span_ids)
            tid = threading.get_ident()
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
        return Span(self, trace_id, sid, parent_id, name, time.perf_counter(), attrs)

    def root(self, name: str, force: bool = False, **attrs) -> Optional[Span]:
        """Start a new root span iff this root is sampled, else ``None``.
        ``force=True`` bypasses sampling (and does not consume a sampling
        slot) — for rare, always-interesting roots like hot-swaps."""
        if not force:
            with self._lock:
                i = self._roots_seen
                self._roots_seen += 1
                take = self._period > 0 and i % self._period == 0
                if take:
                    self.sampled_roots += 1
            if not take:
                return None
        with self._lock:
            trace_id = next(self._trace_ids)
        return self._start(name, trace_id, None, attrs)

    def child(self, parent: Optional[Span], name: str, **attrs) -> Optional[Span]:
        """Child of ``parent``, or ``None`` when the parent wasn't sampled."""
        if parent is None:
            return None
        return parent.child(name, **attrs)

    def add_span(self, parent: Optional[Span], name: str,
                 t0: float, t1: float, **attrs) -> None:
        """Record an already-elapsed interval (``perf_counter`` endpoints) as
        a finished child span — for phases measured before the span's shape
        was known, e.g. queue wait reconstructed at dispatch time."""
        if parent is None:
            return
        sp = self._start(name, parent.trace_id, parent.span_id, attrs)
        sp.t0 = t0
        sp._ended = True
        sp.t1 = t1
        self._finish(sp)

    def live(self, parent: Optional[Span], name: str, **attrs) -> Optional[Span]:
        """:meth:`child`, mirrored as a profiler range while a profiler
        records (:func:`mirror`): end it on this thread, innermost first."""
        sp = self.child(parent, name, **attrs)
        if sp is not None:
            sp._mirror = mirror(name)
            if sp._mirror is not None:
                sp.t0 = time.perf_counter()   # inside the range, whose start the profiler stamped
        return sp

    @contextmanager
    def span(self, parent: Optional[Span], name: str, **attrs):
        sp = self.live(parent, name, **attrs)
        try:
            yield sp
        finally:
            if sp is not None:
                sp.end()

    # -- collection & export ----------------------------------------------

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._done.append(span)

    def spans(self) -> list:
        with self._lock:
            return list(self._done)

    def unix_us(self, t: float) -> int:
        """A ``perf_counter`` reading as whole Unix-epoch microseconds, the
        clock of ``torch.profiler``'s Chrome trace."""
        return round(self.epoch_unix_ns / 1e3 + (t - self.epoch) * 1e6)

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (perfetto-loadable): one "X" complete
        event per finished span, whole Unix-epoch microseconds (the
        profiler's clock), plus "M" thread-name metadata."""
        with self._lock:
            spans = list(self._done)
            thread_names = dict(self._thread_names)
        tid_map = {t: i for i, t in enumerate(sorted(thread_names), start=1)}
        events = []
        for t, name in thread_names.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid_map[t], "args": {"name": name}})
        for sp in spans:
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            args.update(sp.attrs)
            ts = self.unix_us(sp.t0)
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": ts,
                "dur": max(0, self.unix_us(sp.t1) - ts),
                "pid": 1,
                "tid": tid_map.get(sp.tid, 0),
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.export_chrome(), fh)
