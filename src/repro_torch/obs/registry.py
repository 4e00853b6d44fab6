"""Unified metrics registry: labeled counters/gauges/histograms (§13).

One :class:`MetricsRegistry` owns every metric a component exposes.  All
metrics created through a registry share the registry's re-entrant lock, so
``registry.snapshot()`` is **atomic across the whole registry**: no torn
reads where a counter from before an event is paired with a histogram from
after it.  Metrics constructed standalone get a private lock and the same
per-metric atomicity.

Three metric kinds:

- :class:`Counter` — monotonically increasing integer (``inc``).
- :class:`Gauge` — last-write-wins float (``set`` / ``inc``).
- :class:`Histogram` — log-bucketed (geometric ``GROWTH``-spaced edges from
  1 µs) with exact count/sum/min/max.  Recording is O(1); quantiles resolve
  to a bucket's upper edge — a conservative ≤ ``GROWTH``-factor
  overestimate, never an underestimate, the right bias for SLO gates.
  Histograms **merge**: ``Histogram.merged([h, ...])`` is bucket-wise
  addition, exactly equivalent to recording the union of the samples, which
  lets a router aggregate replica latency without re-measuring.

Exposition: ``snapshot()`` gives the JSON shape the serve CLI and CI gates
already read; ``to_prometheus()`` renders the standard text format.  A
:class:`Sampler` thread appends periodic snapshots to a JSONL file so a run
leaves a queryable time series behind.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

FLOOR_S = 1e-6    # first histogram bucket edge: 1 us
GROWTH = 1.25
NUM_BUCKETS = 96  # 1us * 1.25**95 ~= 1.6e3 s: covers any sane request
_LOG_GROWTH = math.log(GROWTH)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped inside the quoted label value."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_name(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic integer counter."""

    kind = "counter"

    def __init__(self, name: str = "", labels: Optional[Dict[str, str]] = None,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = lock if lock is not None else threading.RLock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters are monotonic: inc(n) requires n >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float gauge."""

    kind = "gauge"

    def __init__(self, name: str = "", labels: Optional[Dict[str, str]] = None,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = lock if lock is not None else threading.RLock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def max(self, v: float) -> None:
        """Raise the gauge to ``v`` if larger (peak tracking)."""
        with self._lock:
            if v > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed histogram with exact count/sum/min/max and merge."""

    kind = "histogram"

    def __init__(self, name: str = "", labels: Optional[Dict[str, str]] = None,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = lock if lock is not None else threading.RLock()
        self._counts = [0] * NUM_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    @staticmethod
    def _bucket(seconds: float) -> int:
        if seconds <= FLOOR_S:
            return 0
        return min(NUM_BUCKETS - 1, 1 + int(math.log(seconds / FLOOR_S) / _LOG_GROWTH))

    @staticmethod
    def _edge(bucket: int) -> float:
        """Upper edge of ``bucket`` in seconds: bucket b holds samples in
        ``[FLOOR·GROWTH^(b-1), FLOOR·GROWTH^b)`` (bucket 0: everything ≤ FLOOR)."""
        return FLOOR_S * GROWTH**bucket

    def record(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._counts[self._bucket(seconds)] += 1
            self.count += 1
            self.sum += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)

    def merge_from(self, other: "Histogram") -> None:
        """Fold ``other`` into self — equivalent to having recorded the union
        of both sample sets (bucket-wise addition + exact-stat folding)."""
        o_counts, o_count, o_sum, o_min, o_max = other._state()
        with self._lock:
            for b in range(NUM_BUCKETS):
                self._counts[b] += o_counts[b]
            self.count += o_count
            self.sum += o_sum
            self.min = min(self.min, o_min)
            self.max = max(self.max, o_max)

    @classmethod
    def merged(cls, hists: Iterable["Histogram"]) -> "Histogram":
        out = cls()
        for h in hists:
            out.merge_from(h)
        return out

    def _state(self) -> tuple:
        """Atomic copy of the mutable state (counts, count, sum, min, max)."""
        with self._lock:
            return list(self._counts), self.count, self.sum, self.min, self.max

    @staticmethod
    def _quantile_from(counts, count, max_v, q: float) -> float:
        if count == 0:
            return 0.0
        target = max(1, math.ceil(q * count))
        cum = 0
        for b, c in enumerate(counts):
            cum += c
            if cum >= target:
                return min(Histogram._edge(b), max_v)
        return max_v

    def quantile(self, q: float) -> float:
        """Latency (seconds) at quantile ``q`` in (0, 1]: the upper edge of
        the bucket holding the ceil(q·count)-th sample; 0.0 when empty."""
        counts, count, _, _, max_v = self._state()
        return self._quantile_from(counts, count, max_v, q)

    def snapshot(self) -> dict:
        """Atomic snapshot: one state copy under the lock, quantiles computed
        from that copy — a concurrent writer can never tear count vs sum."""
        counts, count, sum_s, min_s, max_s = self._state()
        qf = lambda q: self._quantile_from(counts, count, max_s, q)
        return {
            "count": count,
            "mean_ms": (sum_s / count * 1e3) if count else 0.0,
            "min_ms": (min_s * 1e3) if count else 0.0,
            "max_ms": max_s * 1e3,
            "p50_ms": qf(0.50) * 1e3,
            "p95_ms": qf(0.95) * 1e3,
            "p99_ms": qf(0.99) * 1e3,
        }


class MetricsRegistry:
    """Central metric registry with atomic cross-metric snapshots.

    ``counter/gauge/histogram`` get-or-create by (name, labels); every metric
    shares the registry lock, so ``snapshot()`` (taken under that lock) is a
    single consistent cut across all of them.
    """

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: Dict[Tuple[str, str, tuple], object] = {}

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]]):
        labels = dict(labels or {})
        key = (cls.kind, name, _label_key(labels))
        with self.lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, lock=self.lock)
                self._metrics[key] = m
            return m

    def register(self, metric):
        """Adopt a pre-built metric (e.g. a Histogram subclass).  The metric
        must have been constructed with ``lock=registry.lock`` to keep
        registry-wide snapshots atomic."""
        key = (metric.kind, metric.name, _label_key(metric.labels))
        with self.lock:
            self._metrics[key] = metric
        return metric

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, labels)

    def metrics(self) -> list:
        with self.lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """One atomic cut across every registered metric (JSON-able)."""
        with self.lock:
            out: Dict[str, object] = {}
            for m in self._metrics.values():
                key = _prom_name(m.name, m.labels)
                if isinstance(m, Histogram):
                    out[key] = m.snapshot()
                elif isinstance(m, Counter):
                    out[key] = m.value
                else:
                    out[key] = m.value
            return out

    def raw_snapshot(self) -> dict:
        """One atomic cut at full resolution — the SLO evaluator's input.

        Counters and gauges map to plain floats; histograms map to
        ``{"kind": "histogram", "counts": [...], "count": n, "sum": s}``
        with the per-bucket counts intact, so a consumer can difference two
        cuts and compute windowed error fractions ("requests over the
        latency objective between t0 and t1") that ``snapshot()``'s
        pre-reduced quantiles cannot express."""
        with self.lock:
            out: Dict[str, object] = {}
            for m in self._metrics.values():
                key = _prom_name(m.name, m.labels)
                if isinstance(m, Histogram):
                    counts, count, sum_s, _, _ = m._state()
                    out[key] = {"kind": "histogram", "counts": counts,
                                "count": count, "sum": sum_s}
                else:
                    out[key] = float(m.value)
            return out

    def to_prometheus(self) -> str:
        """Standard Prometheus text exposition (one atomic cut)."""
        with self.lock:
            lines = []
            seen_types = set()
            for m in self._metrics.values():
                if m.name not in seen_types:
                    lines.append(f"# TYPE {m.name} {m.kind}")
                    seen_types.add(m.name)
                full = _prom_name(m.name, m.labels)
                if isinstance(m, Histogram):
                    counts, count, sum_s, _, _ = m._state()
                    cum = 0
                    for b, c in enumerate(counts):
                        cum += c
                        if c == 0:
                            continue
                        lab = dict(m.labels)
                        lab["le"] = f"{Histogram._edge(b):.9g}"
                        lines.append(f"{_prom_name(m.name + '_bucket', lab)} {cum}")
                    inf_lab = dict(m.labels)
                    inf_lab["le"] = "+Inf"
                    lines.append(f"{_prom_name(m.name + '_bucket', inf_lab)} {count}")
                    lines.append(f"{_prom_name(m.name + '_sum', m.labels)} {sum_s:.9g}")
                    lines.append(f"{_prom_name(m.name + '_count', m.labels)} {count}")
                else:
                    lines.append(f"{full} {m.value:.9g}" if isinstance(m, Gauge)
                                 else f"{full} {m.value}")
            return "\n".join(lines) + "\n"


class Sampler:
    """Background thread appending periodic registry snapshots to a JSONL
    file — each line ``{"t": epoch_seconds, "metrics": {...}}``.  ``stop()``
    always writes one final sample so short runs still leave a series."""

    def __init__(self, registry: MetricsRegistry, path: str, interval_s: float = 1.0):
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh = None
        self.samples_written = 0

    def _write_sample(self) -> None:
        line = json.dumps({"t": time.time(), "metrics": self.registry.snapshot()})
        self._fh.write(line + "\n")
        self._fh.flush()
        self.samples_written += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_sample()

    def start(self) -> "Sampler":
        self._fh = open(self.path, "a")
        self._thread = threading.Thread(target=self._run, name="obs-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._fh is not None:
            self._write_sample()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
